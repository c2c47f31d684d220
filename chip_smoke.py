#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main paths -- TVTSv2 video feature
extraction, zero-shot eval (retrieval, prompt recognition, SSV2 multiple
choice) and the pretraining step (forward, backward, AdamW) through the
hand-written Hopper kernels, for B/16, B/32 and H/14, TVTS v1
pretraining and the v1 SSV2 downstream stack (eager, as in the JAX package)
-- on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero; they
run in the order 1-5, 10, 7, 6, 11, 12, 15, 16, 17, 13, 14, 18 for B/16, v1 and
the downstream encoders, then 9 (B/32) and 8 (H/14, with phase 15's and 16's
H/14 gates) with their times):
1. refuse to run without CUDA; print the card's name and power limit;
2. build the kernels from tvts_torch/csrc with nvcc (sm_90a, one nvcc per
   translation unit, all at once); print the build seconds, the -Xptxas -v
   register / shared-memory / spill lines and any wgmma serialisation ptxas
   reports;
3. kernel parity, in bf16 on seeded inputs against the plain PyTorch versions
   on the card: H1-H4 at the B/16 shape (B=2), at N=49 (B/32) and at D=1280,
   H=16 (head dim 80); H7 (text attention) at the B/16 text shape (B=8, S=77,
   D=512, causal), the H/14 text shape (B=4, S=77, D=1024, H=16) and the sort
   head shapes (B/16: B=2, S=1181, D=512; H/14: B=1, S=916, D=1024, H=16;
   non-causal, LN eps 1e-6); the backwards of H6 (time) and H5 (space) at the
   B/16 train shape (B=2, N=98) and at D=1280, H=16 (N=76), with their saving
   forwards; of H7 at the text shapes (B/16 causal, frozen and not; H/14) and
   the sort shapes; H8 (the MLP sub-path) forward (output and saved hidden)
   and every backward gradient, recomputing and saving, at the B/16 train
   shape (quick_gelu) and the H/14 train shape (B=1, S=913, D=1280, exact
   gelu); H9 (the attention cores on q, k, v) space and time at (N=196,
   d=64), (N=49, d=64), (N=256, d=80), in bf16 and in f32 (the f32 kernels
   against plain f32). Forwards within BAND (H9 within min(BAND, 0.02 *
   max|ref|), and no farther from plain in f32 than plain in bf16 is; H9 in
   f32 within F32_BAND = 1e-4 * max|ref|, which a TF32 and a bf16-staged
   control must each fail), each gradient tensor within 0.06 * max|ref| of
   the plain backward; the sha256 of the H1, H2 and bf16 H9 outputs (equal
   digests in two trees: bit-identical outputs);
   the space core's CLS row (f32 P V) within half a bf16 unit of plain;
4. extraction main path: build_model("TVTSv2_B_16") with seeded weights (noise
   on every leaf of both towers), extract_embeddings over 3 batches of 8
   synthetic clips (the last ragged) through the kernels; launch counts
   12/11/11/1 per forward; pooled cosine against the eager tower in bf16 and
   in f32; extract_video_feature; then the eager tower built with
   use_pallas=True (12 H9 space launches a forward) against the same tower
   without it, in bf16 and in f32 (cosine >= 0.995 and max|diff| within
   F32_TOWER_BAND = 1e-5 * max|ref| of the f32 tower, which the tower with
   H9 as the TF32 or bf16-staged control must each fail; 12 f32 H9 launches
   a forward); H9 in time mode on f32 q, k, v at the tower's shape (B=8), the
   entry called directly as no tower calls it (one launch of the f32 time
   core), within F32_BAND of plain f32;
5. zero-shot main path, kernels on both towers: run_retrieval over 21
   clip-caption pairs in batches of 8, run_recognition over a few class
   names, run_ssv2_mc with a few options per clip; 11 H7 launches per text
   forward; per-caption text cosine against the eager tower in bf16 and f32;
   t2v / v2t metrics of the kernel and eager paths and the max |diff| of
   their similarity matrices;
10. the data path, from a config file and video files through the CLIs, at
   full B/16 width and depth with phase 4's seeded weights saved as a
   reference .pth: under a temporary directory, the MSRVTT (96 clips of
   320x240 at 30 fps, 8 s, 20 captions each, the jsfusion caption index
   pickled as a plain dict), UCF101 (48 clips, label2id.json) and SSV2-MC (48
   clips of 427x240, 5 options each) layouts, read through the repo's
   tvts_tpu/configs/zero-{msrvtt,ucf101,ssv2-mc}-vit-b-16.json with data_dir,
   meta_root and num_workers (the machine's cores) overridden; the clips are
   written with cv2 and decoded through video_reader (the native decoder is
   built where pkg-config finds FFmpeg, and a failed build fails the run;
   with no backend at all, seeded frames are injected at
   video_reader.read_frames_at and the line says so). tvts_torch.cli.zero_ret
   with --fused: launches 12/11/11/1 (H1-H4) a video forward and 11 H7 a text
   forward; its embeddings bit for bit make_embed_fns(use_fused=True) on the
   batches the loader yielded, cosine >= 0.999 to the eager towers by row;
   the metrics of both; clips/s from files inside extract_embeddings, the
   seconds waiting on the loader (host share), in embed_video and embed_text,
   beside phase 6's device-resident rate, and the same at 2, 4 and 8 loader
   workers, threads and the fork pool (a fork that crashes or deadlocks
   fails the phase). tvts_torch.cli.feature_extraction
   --fused: the saved .npy bit for bit the array entry on the same clip (and
   --fast_pipeline's cosine to it). tvts_torch.cli.zero_recognition and
   zero_ssv2_mc (eager towers, as the JAX scripts): their results equal to
   the in-memory run_recognition / run_ssv2_mc on the same batches;
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
   H1-H4 not called; then the same gate with mlp_mode="pallas" (12 H8
   forwards and backwards a step, recomputing the hidden) and with
   layout="dmajor" (the same, from the saved hidden);
6. times with CUDA events after warm-up: clips/s at B=64 and captions/s at
   B=256 (kernels, eager), each kernel against its plain version; the device
   time by CUDA kernel of one B=64 extraction forward and of H1-H4 alone
   (torch.profiler; H2 must launch no cls_partial, H4 no ln_gemm); the space
   core alone at B=64 against its byte bound and one masked
   scaled_dot_product_attention; every ln_gemm product shape of the B/16 extraction
   forward and train step (ms, TFLOP/s, bound, one F.linear on the same
   operands as library_ms; a LayerNorm product's time includes its row
   pass), then the four of a VideoMAE V2 ViT-g/14 joint block at B=15
   (joint_gemm_products), then five of fewer tiles than SMs, each with its
   tiles and blocks and the sha256 of its outputs, every output held to
   plain, printed as {"ln_gemm": [...]}, and the per-tile and per-k-step costs
   fitted to proj and c_proj as {"ln_gemm_fit": ...}; the LayerNorm row pass alone at the
   B/16 (B=48, 64) and H/14 (B=24) extraction shapes against its byte
   bound, printed as {"ln_rows": [...]}; every wgrad
   product of the B/16 step at B=20 and the H/14 step at B=8 (device ms,
   TFLOP/s, bound, one torch.matmul(a.t(), b) as library_ms, each held
   against wgrad_plain), printed as {"wgrad": [...]}; the backward time core
   alone at B=20 against its byte bound and plain backward, and the sha256 of
   its dqkv and CLS partials at the B/16 (N=98, d=64) and H/14 (N=76, d=80)
   train shapes (equal digests in two trees: bit-identical outputs); the
   backward space core alone at the B/16 (B=20) and H/14 (B=8) train shapes
   against its byte bound, the plain backward, the flash pair and one masked
   scaled_dot_product_attention backward (library_ms), and the sha256 of its
   dqkv and CLS partials (bit for bit the pair's: printed); the LayerNorm
   backward alone (row pass and column sums) at the same shapes against its
   byte bound, plain and one aten native_layer_norm_backward (library_ms),
   split by kernel, and the sha256 of its dx; the H7 cores alone
   (`text_core`, `text_core_backward`) at the B/16 and H/14 sort and text
   shapes, each held against its plain version (out, lse, dq, dk, dv) and
   bit-equal over two runs, with the sha256 of out, lse and dqkv, against
   their bound and one scaled_dot_product_attention forward or backward
   (`library_ms`), and the forward alone at head dim 88 at the ViT-g joint
   shape (TEXT_CORE_FWD_SHAPES), printed as {"text_core_forward": ...}; the train
   step at B=20 (ms, clips/s, peak memory; kernels, kernels with
   mlp_mode="pallas", eager), each backward kernel, the saving forwards, H8
   and H9 against their plain versions at the B=20 shapes (H9 also against
   the one library call that computes it, a masked
   scaled_dot_product_attention: `library_ms`), and the
   device-time breakdown of one kernel-path train step from torch.profiler,
   which fails if the step's LayerNorm column sums take more than
   LN_SUMS_MS (where torch.profiler records no device activity in
   PROFILE_ATTEMPTS sessions in a row, a device time is taken by CUDA events
   instead, and a breakdown, with the checks read from it, is left out; the
   line before the card's name lists both); H9 in f32, space and time, at phase 4's tower shape (B=8,
   N=196) and H/14's frame (B=4, N=256, d=80) against plain f32, one masked
   f32 scaled_dot_product_attention and two bounds (f32 bytes, and the
   operations at the f32 FMA rate or as three TF32 tensor-core products);
11. pretraining from files: under a temporary directory, the YT-Temporal
   layout (72 videos of 30 s at 30 fps, 320x240, ASR annotations of ~2.5
   words a second with junk words and a denoised text the DTW aligns) and the
   WebVid one (48 clips of 10 s at 25 fps, 596x336), read through the repo's
   tvts_tpu/configs/dist-yt-web-pt-vit-b-16-fused.json (data_dir, meta_root
   and num_workers overridden) by its two loaders in turn, prepare_batch and
   prefetch_to_device into the B/16 step (full width and depth, f32 masters,
   bf16 compute, phase 7's optimizer) under the file's trainer.kernels: the
   first YT-Temporal batch's shapes (video [12, 12, 3, 224, 224] f32, 48
   text rows, labels arange(4), keep_ind [12, 98]), the step-0 gate on it, 8
   steps with finite losses and per-step launches as phase 7 (no sort head
   without labels), frozen blocks unchanged, every prefetched batch bit for
   bit its host batch; clips/s from files over steps 3-8 and the host share
   beside the device-resident step at B=12; a YT-Temporal item's host time
   split (caption and DTW, decode, transform) and get_caption_multi on a
   600-word annotation;
12. the Trainer on the same files, through tvts_torch.cli.train_dist_TVTSv2's
   main with a 1-rank NCCL process group (--coordinator localhost:<free
   port>), so the sharded step's all-gathers, sort-loss means and gradient
   all-reduce run as NCCL launches: the pretraining config edited only in
   data_dir, meta_root, num_workers, epochs (2), max_samples_per_epoch (6
   steps a loader an epoch) and save_dir (a directory the phase removes), val
   splits of the first 24 videos of each layout; full B/16 width and depth,
   B=12, bf16 compute over f32 masters, init_val and "min val_loss_0" as the
   file has them. It fails unless every step's launches are phase 7's (219
   with the sort head, 212 without) and its loss finite, the init and both
   epochs' validations ran, checkpoint-epoch{1,2}.pth and model_best.pth were
   written, the epoch-2 file built by strict build_model gives a val batch's
   embeddings bit for bit the trained model's, and `-r checkpoint-epoch1.pth`
   restores parameters, AdamW state, step count and monitor_best bit for bit
   and runs epoch 2; it prints the Trainer's clips/s and host share over
   steps 3-12 of epoch 1 beside phase 11's bare loop, each validation, and
   each checkpoint's size and seconds to save;
13. TVTS v1 at full width (TVTSv1Config(): the joint ViT 12 x 768 over 8
   tubes x 49 kept of 16 frames at 224², S = 393; DistilBERT 6 x 768, vocab
   30522, 50 tokens; the sort head at 768, S = 397; 167.33 M parameters),
   seeded weights with noise on every leaf: the forward at B=16 in bf16
   against f32 (cosine of both embeddings >= V1_COS = 0.995, |dloss| <
   V1_DLOSS = 2e-2; the worst relative gradient error printed); the forward
   and the step (tvts_torch.train.optim.make_v1_optimizer) on a
   device-resident batch (ms, clips/s, peak memory; no hand-written kernel
   launched) and one profiled step's busy ms, idle share and top kernels;
   then tvts_torch.cli.train_dist_TVTS's main with a 1-rank NCCL group on the
   repo's v1-dist-yt-pt.json, edited only in data_dir, meta_root (phase 11's
   72 YT-Temporal videos listed 3 times), num_workers (8), epochs,
   max_samples_per_epoch (12 steps of 16) and save_dir, with a WordPiece
   vocab over the synthetic ASR words: finite losses with loss_ce > 0,
   clips/s and host share over steps 3-12 beside the device-resident rate,
   the checkpoint's size and seconds, the epoch file rebuilt strictly by
   build_v1_model bit for bit on a batch's embeddings, and `-r` restoring
   parameters, AdamW state and step count bit for bit before a resumed
   epoch of 4 steps; v1-dist-cc-web-pt.json's CC3M loader over 96
   cv2-written PNG and JPEG images (shapes, items/s), and the CLI twin's
   refusal of that config by name;
14. the v1 SSV2 downstream stack at scripts/sh/ft_ssv2.sh's width, training
   eager as in the JAX package, the CLI's evaluation on the kernels (the H7
   core and H3 once a block an eval call, no other kernel): a seeded
   v1 .pth (TVTSv1Config() with noise on every leaf, save_reference_checkpoint)
   -> FinetuneViT (174 classes, 16 frames of 224², ViT-B/16, S = 1568, 86.37 M
   parameters, remat) through load_pretrain_video_tower (the transferred
   tensors bit for bit, fc_norm and head at init); at step 0, with noise on
   the head, bf16 against f32 at B=12 (cosine of the pooled fc_norm features
   and of the logits >= FT_COS = 0.995, |dloss| < FT_DLOSS = 2e-2; the worst
   relative gradient error printed); the CLI's fused eval forward (its
   logits within FT_EVAL_TOL of eager model(video)'s, both timed), the
   finetune and the linear-probe steps on a device-resident B=12 batch (ms,
   clips/s, peak memory) and one profiled finetune step (busy ms, idle share, top
   kernels); then, on an SSV2-shaped tree of cv2-written 427x240 clips (48
   frames at 12 fps, 96 train / 24 val / 12 test videos, 174-class labels),
   tvts_torch.cli.run_class_finetuning --mode finetune --model_ema with
   ft_ssv2.sh's flags for one epoch (finite losses, clips/s and the host
   clock split over steps 3-8 beside the resident rate, a training item's
   host time split into decode, resize and crop, RandAugment, normalise and
   erase, the seconds of validation, of the multi-view test (12 videos x 6
   views, each merged) and of the checkpoint), run_class_linear with
   linear_ssv2.sh's flags for FT_LINEAR_STEPS steps (the first 36 train
   videos, 12 val, no test; every backbone tensor bit for bit the
   checkpoint's, head and fc_norm moved) and run_class_zero over the 24 val
   videos (R@1/5/10; the first batch's features bit for bit
   JointViT(video)[:, 0]);
15. --fsdp sharding (tvts_torch/parallel/partition.fsdp_shard: FSDP2 over
   the ("dp", "fsdp") DeviceMesh, a unit a block) through the kernel steps on
   a 1-rank NCCL group (one card: every collective is a copy): phase 7's
   B/16 model and optimizer at B=12 under the "best" preset, a copy sharded
   and its optimizer built after sharding; 3 steps of each on the same
   batches: each sharded step's launches phase 7's (219), its aux and after
   the steps every parameter bit for bit the unsharded step's (else the
   max|diff| within 2e-5 of each tensor's largest update); ms a step and
   peak memory of both (unsharded, sharded, sharded, unsharded) and one
   profiled step of each (device busy, NCCL kernels, the host ranges of
   FSDP2's hooks and the optimizer's step); a checkpoint gathered from the
   shards (the unsharded layout) rebuilt by strict build_model gives a
   batch's embeddings, sort accuracy and loss bit for bit the sharded
   model's. Inside phase 8, after its every-kernel gate: a sharded copy of
   the H/14 model at B=4 through the preset and the every-kernel forward
   and backward (phase 8's launches), each through the step-0 gate against
   the eager unsharded model, its loss equal to the unsharded kernel path's;
16. --tp (tvts_torch/parallel/tensor_parallel.py: Megatron's column -> row
   pairs on local slices, the qkv rows cut by heads; the kernel path gathers
   each block's slices whole at the kernels) on the same 1-rank NCCL group,
   the mesh (1, 1, 1, 1) and the tp code path forced at group size 1
   (tp_shard cuts at any size, as fsdp_shard shards): phase 15's B/16 model
   at B=12 under the "best" preset, a tp copy and a tp x fsdp copy, each
   with its optimizer built after sharding; 3 steps of each beside the
   unsharded step on the same batches: each copy's launches phase 7's (219),
   its aux and after the steps every parameter bit for bit the unsharded
   step's (else within 2e-5 of each tensor's largest update); ms a step and
   peak memory of each (unsharded, tp, tp x fsdp, tp x fsdp, tp,
   unsharded), one profiled step of each copy (device busy, NCCL kernels,
   the host ranges of the tp Functions, FSDP2's hooks and the optimizer's
   step); a checkpoint gathered from the tp copy (the reference layout)
   rebuilt by strict build_model gives a batch's embeddings, sort accuracy
   and loss bit for bit the tp copy's. Inside phase 8, after phase 15's
   gates: a tp copy of the H/14 model at B=4 through the preset and the
   every-kernel step-0 gates against the eager unsharded model (phase 8's
   launches), the every-kernel loss equal to the unsharded kernel path's
   (the preset's eager sort head runs Megatron's row products, a bf16
   rounding apart). Two to eight ranks run only on the CPU
   (tests/test_torch_tp.py);
17. sequence parallelism (tvts_torch/parallel/sequence_parallel.py: the JAX
   token_partition, the tokens split over sp between the stem and pool,
   all-to-alls from sequence to head slices around each attention core, the
   stem's and blocks' gradients summed over sp) on the same 1-rank NCCL
   group, the sp code path forced at group size 1 (S = 1177 needs no pad
   row there): phase 15's B/16 model at B=12 and a copy carrying the
   partition, through the eager step (the sp copy's aux and after 3 steps
   all 403 parameters bit for bit the eager step's, 48 all-to-alls, one
   gather and one sp gradient sum a step, counted) and the "best" kernel
   step (219 launches, tokens whole, no sp sum, bit for bit); the eager
   tower with use_pallas=True under sp at the extraction shape (12 H9
   space launches a forward, pooled and tokens bit for bit the tower
   without sp, in bf16 and f32); ms a step and peak memory of the eager
   step with and without sp (eager, sp, sp, eager) and one profiled step
   of each (device busy, the host ranges of the all-to-alls, the gather
   and the gradient sums). sp > 1 runs only on the CPU
   (tests/test_torch_sp.py);
18. the Frozen-style encoder (tvts_torch/downstream/video_transformer.py)
   at its published defaults (224^2, patch 16, 768 x 12, 12 heads, 16
   frames, 174 classes, S = 3137) with seeded weights: the forward at B=4
   in bf16 compute over f32 weights against f32 (logits cosine >= 0.995,
   no hand-written kernel launched), clips/s and peak memory at B=8; then
   tvts_torch/downstream/video_transforms.transforms_imagenet_train with
   RandAugment and random erasing over a cv2-written 16-frame 340x256 clip
   (host ms a clip), the result through the encoder (finite logits);
9. B/32: extraction at B=8 through the kernels (counts 12/11/11/1, cosine
   gates), clips/s at B=64 (kernels, eager);
8. H/14 at full width and depth (32 blocks of 1280, text 24 blocks of 1024):
   extraction over 2 batches of 4 clips (last ragged; counts 32/31/31/1,
   cosine gates); zero-shot retrieval (23 H7 launches per text forward);
   clips/s at B=16; the train step with f32 masters and bf16 compute,
   OptimizerConfig(text_layers=24, text_tune_layers=6), B=4: the step-0 gate
   under the "best" preset (H5 space, checkpointed plain time, H7 text with 18
   frozen blocks, plain sort head and MLP), two optimizer steps with frozen
   tensors unchanged, then the gate with every kernel on (time, mlp and sort
   "pallas": per step 32 H5, H6 and H8 forwards and backwards, 24 H7
   forwards and backwards, 18 of them frozen); the step at B=8 (preset, every
   kernel, eager) and the profile of one preset step.
The step profiles also print the device time and launches of every backward
kernel and the H7 cores (STEP_KERNELS), the LayerNorm's column sums apart
from wgrad's, and fail if a step launches the H7 cores of the first design
(OLD_H7_KERNELS). Every
train step's launch counts (phases 7 and 8) include one backward space core a
space backward and no flash pair (`space_core_backward (pair)`).
`python3 chip_smoke.py --profile` runs phases 1 and 2 and then only the
numbers an A/B compares (`profile_phase`): the space core's patch-row digest
and CLS row against plain, the backward time core's, backward space core's
and LayerNorm backward's digests, the B/16 profiles, the space core alone,
H1-H4, the ln_gemm and wgrad tables, the backward time and space cores, the
LayerNorm backward and the H7 cores alone (with their digests), the H5 and
H7 backwards split by kernel, the
step at B=20 (also with mlp_mode="pallas") with its profile, the saving
forwards, the B/16, B/32 and H/14 extraction rates and the H/14 step with
every kernel at B=8 with its profile.
`python3 chip_smoke.py --ln-gemm OUT.json [AGAINST.json ...]` runs phases 1
and 2 and then only the ln_gemm table (`ln_gemm_phase`), writes its rows to
OUT.json and sets each row's rate beside those of the AGAINST tables (this
script run from a copy of another tree of the port), failing when a digest
differs.
The line before the last is {"kernels": [...]}, each with its bound (the
larger of its bytes over 3.35 TB/s and its flops over 989 TFLOP/s, from the
shapes timed); the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# max|diff| band of the Pallas kernels against XLA in bf16 (0.031-0.047 at
# mean|out| ~0.8), scaled where the reference is larger
BAND = 0.05
# the attention cores alone (H9): max|diff| against plain over max|ref|, never
# above BAND (plain in bf16 rounds its logits and lies 0.006 * max|ref| to
# 0.012 * max|ref| from its own f32 result, so a tighter band would hold the
# kernel to plain's rounding)
CORE_BAND = 0.02
COS_BF16, COS_F32 = 0.999, 0.995
# H9 in f32 against plain f32, max|diff| over max|ref|. The cores alone: f32
# sums in another order lie ~1e-6 from plain, while a kernel that reads q, k,
# v as TF32 (a TF32 mma) lies >= 4e-4 from it and one that stages k, v in
# bf16 >= 3e-3. Phase 4's f32 tower (pooled output) damps all three: ~1.6e-6,
# ~4.7e-5 and ~2.5e-4 on the H100. Each run holds both controls above its
# band (f32_controls, f32_tower_controls), so each band tells f32 from either
F32_BAND, F32_TOWER_BAND = 1e-4, 1e-5
REPLACES = {
    "fused_time_block": "tvts_tpu/ops/pallas_block_attention.py:2456",
    "fused_space_block": "tvts_tpu/ops/pallas_block_attention.py:2964",
    "fused_mlp_block": "tvts_tpu/ops/pallas_block_attention.py:2604",
    "fused_space_cls_only": "tvts_tpu/ops/pallas_block_attention.py:3339",
    "fused_text_attention_block": "tvts_tpu/ops/pallas_text_attention.py:102",
    "time_subpath_backward": "tvts_tpu/ops/pallas_block_backward.py:736",
    "space_subpath_backward": "tvts_tpu/ops/pallas_block_backward.py:3106",
    "text_subpath_backward": "tvts_tpu/ops/pallas_text_attention.py:264",
    "time_subpath": "tvts_tpu/ops/pallas_block_attention.py:643",
    "space_subpath": "tvts_tpu/ops/pallas_block_attention.py:3058",
    "mlp_subpath": "tvts_tpu/ops/pallas_block_attention.py:406",
    "mlp_subpath (saved hidden)": "tvts_tpu/ops/pallas_block_attention.py:2604",
    "mlp_subpath_backward": "tvts_tpu/ops/pallas_block_attention.py:1021",
    "mlp_subpath_backward (saved hidden)": "tvts_tpu/ops/pallas_block_backward.py:2637",
    "divided_space_time_attention_fused": "tvts_tpu/ops/pallas_attention.py:107",
    # H9 on f32 q, k, v: the f32 space core (space_core_f32_kernel, the mode
    # the towers run) with the f32 CLS row, and the f32 time core
    # (time_core_f32_kernel, which only a direct call of the entry reaches)
    "divided_space_time_attention_fused (f32)": "tvts_tpu/ops/pallas_attention.py:31",
    "divided_space_time_attention_fused (f32 time)": "tvts_tpu/ops/pallas_attention.py:69",
    # the weight-gradient half of the backward kernels (also :736, :2637;
    # pallas_block_attention.py:1021; pallas_text_attention.py:264)
    "wgrad": "tvts_tpu/ops/pallas_block_backward.py:3106",
    # the attention-core part of fused_time_attention_block_v2_bwd (:736)
    "time_core_backward": "tvts_tpu/ops/pallas_block_backward.py:501",
    # the attention-core part of fused_space_attention_block_v10_bwd (:3106)
    "space_core_backward": "tvts_tpu/ops/pallas_block_backward.py:2722",
    # the LayerNorm part of the backward kernels (_ln_bwd and the dln sums)
    "ln_backward": "tvts_tpu/ops/pallas_block_backward.py:46",
    # H7's attention core alone: the core of fused_text_attention_block (:102)
    # and of fused_text_attention_block_bwd (:264)
    "text_core": "tvts_tpu/ops/pallas_text_attention.py:43",
    "text_core_backward": "tvts_tpu/ops/pallas_text_attention.py:134",
}
SOURCE = "tvts_torch/csrc/block_kernels.cu"
REPO = Path(__file__).resolve().parent
PEAK_FLOPS, HBM_BYTES_S = 989e12, 3.35e12  # H100 SXM: dense bf16, HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM: float32 outside the tensor cores (the f32 H9 time core)
PEAK_TF32_FLOPS = 495e12  # H100 SXM: dense TF32 (the f32 H9 space core, three products a step)
# the TPU's measured real-shape gradient band (5.8e-2, PERF.md before the port)
GRAD_BAND = 0.06
# H5 / H6 backward parity shapes: (B, T, N, D, H)
BWD_SHAPES = {"B/16 train": (2, 12, 98, 768, 12), "D=1280 H=16": (1, 12, 76, 1280, 16)}
# H7 backward parity shapes: (B, S, D, H, causal, LN eps, frozen)
TEXT_BWD_SHAPES = {"text": (8, 77, 512, 8, True, 1e-5, False),
                   "text frozen": (8, 77, 512, 8, True, 1e-5, True),
                   "sort head": (2, 1181, 512, 8, False, 1e-6, False),
                   "H/14 text": (4, 77, 1024, 16, True, 1e-5, False),
                   "H/14 sort head": (1, 916, 1024, 16, False, 1e-6, False)}
# H7 parity shapes: (B, S, D, H, causal, LN eps)
TEXT_SHAPES = {"B/16 text": (8, 77, 512, 8, True, 1e-5),
               "H/14 text": (4, 77, 1024, 16, True, 1e-5),
               "sort head": (2, 1181, 512, 8, False, 1e-6),
               "H/14 sort head": (1, 916, 1024, 16, False, 1e-6)}
# H8 parity shapes: (B, T, N, D, activation)
MLP_SHAPES = {"B/16 train": (2, 12, 98, 768, "quick_gelu"),
              "H/14 train": (1, 12, 76, 1280, "gelu")}
# H9 parity shapes: (B, T, N, H, d)
CORE_SHAPES = {"N=196 d=64": (2, 12, 196, 12, 64), "N=49 d=64": (2, 12, 49, 12, 64),
               "N=256 d=80": (1, 12, 256, 16, 80)}
WORDS = ("a person is playing the guitar on stage while dog runs across green field "
         "under blue sky man cooks pasta in small kitchen woman rides bike through "
         "city street at night children swim pool dance read book").split()


def sha256_of(t: torch.Tensor) -> str:
    """The sha256 of a tensor's bytes: equal digests, bit-identical tensors."""
    import hashlib

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


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


def mlp_calls(bk, bb, a, g, act, save):
    """H8 on the inputs `a` and the output gradient g: (forward kernel ->
    (out, saved hidden or None), forward plain -> (out, hidden), backward
    kernel, backward plain)."""
    from tvts_torch.models.layers import layer_norm_f32, linear

    w = (a["ln_w"], a["ln_b"], a["wfc"], a["bfc"], a["wpr"], a["bpr"])

    def forward():
        out, _, h = bk._mlp_sub_path(a["x"], *w, act, save_hidden=save)
        return out, h

    def forward_plain():
        return (bk.mlp_block_plain(a["x"], *w, act),
                linear(layer_norm_f32(a["x"], a["ln_w"], a["ln_b"]), a["wfc"], a["bfc"]))

    return (forward, forward_plain,
            lambda: bb.vjp(lambda *t: bb.mlp_subpath(*t, act, save), g, (a["x"], *w)),
            lambda: bb.mlp_subpath_backward_plain(g, a["x"], *w, act))


def core_inputs(B, T, N, H, d, seed, device, dtype=torch.bfloat16):
    """q (pre-scaled), k, v [B, H, S, d] as the tower hands them to H9: the
    head-split views of a [B, S, 3D] qkv product (logits of unit variance),
    in bf16 or f32."""
    from tvts_torch.ops.attention import split_heads

    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.standard_normal((B, 1 + T * N, 3 * H * d)), dtype=dtype,
                       device=device)
    q, k, v = qkv.chunk(3, dim=-1)
    return split_heads(q * d ** -0.5, H), split_heads(k, H), split_heads(v, H)


def core_calls(ac, qkv, T, N, mode):
    """(kernel call, plain call) of H9."""
    from tvts_torch.ops.attention import divided_space_time_attention

    return (lambda: ac.divided_space_time_attention_fused(*qkv, T, N, mode),
            lambda: divided_space_time_attention(*qkv, T, N, mode))


def core_library_call(qkv, T, N, mode):
    """H9 as one library call: scaled_dot_product_attention under a constant
    bool [S, S] mask of the divided pattern (the CLS row sees every token; a
    patch row sees the CLS key and its own frame (space) or its own location
    across frames (time)). Timed as `library_ms`; the port never calls it."""
    mask = divided_mask(T, N, mode, qkv[0].device)
    return lambda: torch.nn.functional.scaled_dot_product_attention(*qkv, attn_mask=mask,
                                                                    scale=1.0)


def divided_mask(T: int, N: int, mode: str, device) -> torch.Tensor:
    """The bool [S, S] mask of divided attention: the CLS row sees every token;
    a patch row sees the CLS key and its own frame (space) or its own location
    across frames (time)."""
    idx = torch.arange(T * N, device=device)
    group = idx // N if mode == "space" else idx % N
    mask = torch.ones(1 + T * N, 1 + T * N, dtype=torch.bool, device=device)
    mask[1:, 1:] = group[:, None] == group[None, :]
    return mask


def core_f32_check(ac, qkv32, T: int, N: int, mode: str) -> tuple[float, float, float, float]:
    """H9 on f32 q, k, v against plain f32 (full-f32 products): (max|diff|,
    max|ref|, the band F32_BAND * max|ref| (inside min(BAND, CORE_BAND *
    max|ref|)), and how far plain on the bf16-rounded inputs lies from plain
    f32, which the kernel may not pass either)."""
    from tvts_torch.ops.attention import divided_space_time_attention

    with no_tf32():
        got = ac.divided_space_time_attention_fused(*qkv32, T, N, mode)
        want = divided_space_time_attention(*qkv32, T, N, mode)
        plain16 = divided_space_time_attention(*(t.bfloat16() for t in qkv32), T, N, mode)
    if got.dtype != torch.float32:
        raise AssertionError(f"H9 f32 returned {got.dtype}")
    diff, ref, tol = core_band_check(got, want)
    return diff, ref, min(tol, F32_BAND * ref), (plain16.float() - want).abs().max().item()


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 t rounded to TF32 (10 mantissa bits, to nearest): what a TF32 mma
    reads of an f32 operand."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


# what two kernels that are not f32 would read of f32 q, k, v: a TF32 mma
# (its P V operand's rounding would only add to that), and one staging k and
# v in bf16
F32_CONTROLS = {
    "TF32 q, k, v": lambda q, k, v: (round_tf32(q), round_tf32(k), round_tf32(v)),
    "bf16-staged k, v": lambda q, k, v: (q, k.bfloat16().float(), v.bfloat16().float()),
}


def f32_controls(qkv32, T: int, N: int, mode: str) -> dict:
    """max|diff| to plain f32 of plain on what each F32_CONTROLS kernel reads."""
    from tvts_torch.ops.attention import divided_space_time_attention as plain

    with no_tf32():
        want = plain(*qkv32, T, N, mode)
        return {name: (plain(*read(*qkv32), T, N, mode) - want).abs().max().item()
                for name, read in F32_CONTROLS.items()}


def core_band_check(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max|diff|, max|ref|, tolerance) of an attention core's output: the
    band follows the reference's own scale (CORE_BAND * max|ref|, at most
    BAND), since a core's output is a softmax average far below the sub-paths'
    mean of 0.8."""
    if got.shape != want.shape or not torch.isfinite(got.float()).all():
        raise AssertionError("core output: wrong shape or non-finite")
    diff = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    return diff, ref, min(BAND, CORE_BAND * ref)


MLP_GRAD_NAMES = ("dx", "dln_w", "dln_b", "dwfc", "dbfc", "dwproj", "dbproj")
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


def saving_forward_work(kind: str, B: int, T: int, N: int, D: int, H: int):
    """(flops, bytes) of the training forward of H6 / H5: the inference
    sub-path plus the saved qkv rows, attention output and per-row lse."""
    S = 1 + T * N
    flops, nbytes = attention_work(kind, B, T, N, D, H, backward=False)
    return flops, nbytes + 2 * B * S * 4 * D + 4 * B * H * S


def mlp_work(M: int, D: int, backward: bool, save: bool):
    """(flops, bytes) of H8 over M rows of width D (hidden 4D): two products
    forward; backward four, and a fifth when the hidden is recomputed."""
    product = 2 * M * D * 4 * D
    weights = 2 * 2 * 4 * D * D  # both matrices, bf16
    hidden = 2 * M * 4 * D if save else 0
    if backward:  # g, x in, dx out; weights in, their gradients out
        return (4 if save else 5) * product, 3 * 2 * M * D + 2 * weights + hidden
    return 2 * product, 2 * 2 * M * D + weights + hidden


def core_work(mode: str, B: int, T: int, N: int, H: int, d: int, elem: int = 2):
    """(flops, bytes) of H9: QK^T and PV over the (query, key) pairs of every
    head (the CLS row over every token); q, k, v read and the output written,
    `elem` bytes an element."""
    S = 1 + T * N
    keys = T + 1 if mode == "time" else N + 1
    return 4 * H * d * B * (T * N * keys + S), 4 * elem * B * H * S * d


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> tuple[float, str]:
    """The least time the card could take: max(bytes / HBM rate, flops / peak),
    the peak of the operations' type (bf16 tensor cores unless given)."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
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
    from tvts_torch.ops import attention_cores as ac

    return [*bk.KERNELS, ta.fused_text_attention_block, *bb.KERNELS, ta.text_subpath_backward,
            ta.text_core, ta.text_core_backward, ac.divided_space_time_attention_fused]


def launch_counts(bk, bb, ta) -> dict[str, int]:
    from tvts_torch.ops import attention_cores as ac

    counts = {fn.__name__: fn.launches for fn in counted(bk, bb, ta)}
    counts["text_subpath_backward (frozen)"] = ta.text_subpath_backward.frozen_launches
    counts["mlp_subpath (saved hidden)"] = bb.mlp_subpath.saved_launches
    counts["mlp_subpath_backward (saved hidden)"] = bb.mlp_subpath_backward.saved_launches
    counts["space_core_backward (pair)"] = bb.space_core_backward.pair_launches
    counts["divided_space_time_attention_fused (f32)"] = \
        ac.divided_space_time_attention_fused.f32_launches
    counts["divided_space_time_attention_fused (f32 time)"] = \
        ac.divided_space_time_attention_fused.f32_time_launches
    return counts


def reset_launch_counts(bk, bb, ta) -> None:
    from tvts_torch.ops import attention_cores as ac

    for fn in counted(bk, bb, ta):
        fn.launches = 0
    bk.ln_rows.launches = 0
    bk._ln_gemm.tiles = bk._ln_gemm.blocks = 0
    ta.text_subpath_backward.frozen_launches = 0
    bb.mlp_subpath.saved_launches = bb.mlp_subpath_backward.saved_launches = 0
    bb.space_core_backward.pair_launches = 0
    ac.divided_space_time_attention_fused.f32_launches = 0
    ac.divided_space_time_attention_fused.f32_time_launches = 0


def expect_launches(tag: str, got: dict, want: dict) -> None:
    """Fail unless the launch counts are `want`, and 0 for every other kernel."""
    full = dict.fromkeys(got, 0)
    full.update(want)
    if got != full:
        raise AssertionError(f"{tag}: launches {got}, expected {full}")


def grads_of(model, loss_fn, batch) -> tuple[float, dict]:
    """(loss, name -> f32 gradient) of the trainable parameters (zeros where
    the loss misses one); a sharded model's gradients gathered whole (over
    fsdp, then tp)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    model.zero_grad(set_to_none=True)
    loss, _ = loss_fn(model, batch)
    loss.backward()
    from tvts_torch.parallel import tensor_parallel as tp

    grads = {}
    for n, p in named:
        g = torch.zeros(p.shape, device=p.device) if p.grad is None \
            else p.grad.full_tensor() if hasattr(p.grad, "full_tensor") else p.grad
        layout = tp.param_layout(p)
        grads[n] = (g if layout is None else tp.full(g, layout)).float()
    model.zero_grad(set_to_none=True)
    return loss.item(), grads


def add_noise_(model, seed: int, dev) -> None:
    """Seeded N(0, 0.02^2) noise on every leaf (the time attention is zero at
    init), from a generator on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen, device=dev))


def build_train(arch: str, dev, noise_seed: int, text_tune_layers: int, tag: str) -> dict:
    """build_model(arch, eval_mode=False) with f32 masters, bf16 compute and
    seeded noise on every leaf, and the optimizer of tools/train_bench.py."""
    from tvts_torch.models.factory import build_model
    from tvts_torch.train.optim import OptimizerConfig, freeze_mask, make_optimizer

    cfg, model = build_model(arch, eval_mode=False, device=dev, seed=0,
                             compute_dtype=torch.bfloat16)
    add_noise_(model, noise_seed, dev)
    v = cfg.vision
    ocfg = OptimizerConfig(schedule=(6, 8), steps_per_epoch=1000, text_layers=cfg.text.layers,
                           text_tune_layers=text_tune_layers)
    optimizer = make_optimizer(model, ocfg)
    frozen = [n for n, f in freeze_mask(model, ocfg).items() if f]
    print(f"[{tag}] {cfg.name} train: mask {v.mask_ratio}, n_keep {v.n_keep}, "
          f"S = {1 + v.num_frames * v.n_keep}; {sum(p.numel() for p in model.parameters())} "
          f"f32 master parameters, bf16 compute; {len(frozen)} frozen tensors "
          f"(text blocks 0-{ocfg.text_tune_from - 1})")
    return dict(cfg=cfg, model=model, optimizer=optimizer, ocfg=ocfg, frozen=frozen)


def kernel_apply(train: dict, tag: str, **overrides):
    """train_apply under the arch's "best" preset with `overrides`."""
    from functools import partial

    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.ops.kernel_config import resolve_kernel_config, train_apply_kwargs

    kcfg = resolve_kernel_config(train["cfg"].name, {"preset": "best", **overrides})
    kwargs = train_apply_kwargs(kcfg, train["ocfg"])
    print(f"[{tag}] kernel config {kcfg} -> {kwargs}")
    return partial(train_apply, **kwargs)


def step0_gate(tag: str, label: str, model, batch, apply_fn, bk, bb, ta) -> dict:
    """The kernel path against the eager path at the current parameters
    (gate_check). Returns the launches of the kernel path's one forward and
    backward."""
    from tvts_torch.train.step import make_loss_fn

    reset_launch_counts(bk, bb, ta)
    loss_k, gk = grads_of(model, make_loss_fn(apply_fn=apply_fn), batch)
    torch.cuda.synchronize()
    launches = launch_counts(bk, bb, ta)
    gate_check(tag, label, loss_k, gk, *grads_of(model, make_loss_fn(), batch))
    print(f"[{tag}] {label}: launches of one forward and backward: "
          f"{ {k: n for k, n in launches.items() if n} }")
    return launches


def gate_check(tag: str, label: str, loss_k: float, gk: dict, loss_e: float, ge: dict) -> None:
    """The step-0 gate: |dloss| < 2e-2, worst relative gradient error < 0.12
    over tensors with max|g| > 1e-2 * global, of the kernel path's loss and
    gradients against the eager path's."""
    gscale = max(g.abs().max().item() for g in ge.values())
    rows = []
    for name, e in ge.items():
        amax = e.abs().max().item()
        err = (gk[name] - e).abs().max().item()
        rows.append((err / (amax + 1e-6), err, amax, name))
    sig = sorted((r for r in rows if r[2] > 1e-2 * gscale), reverse=True)
    print(f"[{tag}] {label}: step-0 loss kernels {loss_k:.6f} eager {loss_e:.6f} |diff| "
          f"{abs(loss_k - loss_e):.3e} (< 2e-2); global max|g| {gscale:.3e}; top 5 by "
          f"relative error among {len(sig)} significant tensors (max|g| > 1e-2 * global):")
    for rel, err, amax, name in sig[:5]:
        print(f"[{tag}]   rel {rel:.3e} abs {err:.3e} max|g| {amax:.3e} {name}")
    if not np.isfinite(loss_k) or abs(loss_k - loss_e) >= 2e-2 or (sig and sig[0][0] >= 0.12):
        raise AssertionError(f"{label}: kernel path disagrees with the eager path at step 0")


def optimizer_steps(tag: str, train: dict, apply_fn, batch, n_steps: int, bk, bb, ta) -> dict:
    """n optimizer steps on the kernels: finite losses, frozen tensors
    unchanged bit for bit, every trainable tensor moved. Returns the launches."""
    from tvts_torch.train.step import make_train_step

    model, frozen = train["model"], train["frozen"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, train["optimizer"], train["ocfg"], apply_fn=apply_fn)
    reset_launch_counts(bk, bb, ta)
    for i in range(n_steps):
        aux = {k: v.item() for k, v in step(batch).items()}
        print(f"[{tag}] step {i}: " + ", ".join(f"{k} {v:.6f}" for k, v in aux.items()))
        if not all(np.isfinite(list(aux.values()))):
            raise AssertionError(f"train step {i}: non-finite {aux}")
    torch.cuda.synchronize()
    launches = launch_counts(bk, bb, ta)
    print(f"[{tag}] launches over {n_steps} steps: { {k: n for k, n in launches.items() if n} }")
    moved, changed = [], []
    for n, p in model.named_parameters():
        same = torch.equal(p.detach(), before[n])
        (changed if n in frozen and not same else moved if n not in frozen and same
         else []).append(n)
    if changed or moved:
        raise AssertionError(f"frozen tensors changed {changed}; trainable unmoved {moved}")
    print(f"[{tag}] {len(frozen)} frozen tensors unchanged bit for bit; all "
          f"{len(before) - len(frozen)} trainable tensors moved")
    return launches


def step_launches(layers: int, text_layers: int, frozen: int, n_steps: int = 1, time=True,
                  mlp=False, sort=True, saved=False) -> dict:
    """The launches of n train steps: per step `layers` H5 (and H6, H8)
    forwards and backwards, text_layers - 1 text and one sort H7 forwards and
    as many backwards, `frozen` of them dx-only; two wgrad products each
    backward that is not frozen, one LayerNorm backward each backward, one
    backward space core (the one-pass kernel, never the pair) each H5
    backward, one backward time core each H6 backward, one H7 core forward
    and backward each H7 forward and backward."""
    text = text_layers - 1 + sort
    want = {"space_subpath": layers, "space_subpath_backward": layers,
            "fused_text_attention_block": text, "text_subpath_backward": text,
            "text_core": text, "text_core_backward": text,
            "text_subpath_backward (frozen)": frozen,
            "wgrad": 2 * (layers * (1 + time + mlp) + text - frozen),
            "space_core_backward": layers, "ln_backward": layers * (1 + time + mlp) + text}
    if time:
        want.update({"time_subpath": layers, "time_subpath_backward": layers,
                     "time_core_backward": layers})
    if mlp:
        want.update({"mlp_subpath": layers, "mlp_subpath_backward": layers})
    if saved:
        want.update({"mlp_subpath (saved hidden)": layers,
                     "mlp_subpath_backward (saved hidden)": layers})
    return {k: n * n_steps for k, n in want.items()}


def train_phase(dev, bk, bb, ta) -> dict:
    """Phase 7 (module notes). Returns what phase 6 times."""
    train = build_train("TVTSv2_B_16", dev, noise_seed=11, text_tune_layers=3, tag="7")
    cfg = train["cfg"]
    L, TL = cfg.vision.layers, cfg.text.layers
    best = kernel_apply(train, "7")
    batch = train_batch(cfg, 8, seed=12, device=dev)
    got = step0_gate("7", "preset", train["model"], batch, best, bk, bb, ta)
    expect_launches("train gate", got, step_launches(L, TL, 9))
    n_steps = 3
    launches = optimizer_steps("7", train, best, batch, n_steps, bk, bb, ta)
    expect_launches("train steps", launches, step_launches(L, TL, 9, n_steps))
    # H8 on the same path: recomputing (mlp_mode="pallas"), then saving (the all-kernel layout)
    mlp = kernel_apply(train, "7", mlp_mode="pallas")
    got = step0_gate("7", 'mlp_mode="pallas"', train["model"], batch, mlp, bk, bb, ta)
    expect_launches("train gate, H8", got, step_launches(L, TL, 9, mlp=True))
    launches.update({k: got[k] for k in ("mlp_subpath", "mlp_subpath_backward")})
    got = step0_gate("7", 'layout="dmajor"', train["model"], batch,
                     kernel_apply(train, "7", layout="dmajor"), bk, bb, ta)
    expect_launches("train gate, H8 saving", got, step_launches(L, TL, 9, mlp=True, saved=True))
    launches.update({k: got[k] for k in ("mlp_subpath (saved hidden)",
                                         "mlp_subpath_backward (saved hidden)")})
    return dict(train, kernel_apply=best, mlp_apply=mlp, launches=launches)


def step_timing(step, batch, iters: int = 3) -> tuple[float, float]:
    """(ms a step by the host clock around synchronised steps after one
    warm-up step, peak GiB of device memory over them)."""
    step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        step(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3, torch.cuda.max_memory_allocated() / 2 ** 30


def time_steps(tag: str, label: str, train: dict, apply_fn, batch, card: str,
               iters: int = 3) -> float:
    """ms of one optimizer step (host clock around synchronised steps), with
    clips/s and the peak device memory."""
    from tvts_torch.train.step import make_train_step

    B = batch["video"].shape[0]
    ms, mem = step_timing(make_train_step(train["model"], train["optimizer"], train["ocfg"],
                                          apply_fn=apply_fn), batch, iters)
    print(f"[{tag}] {train['cfg'].name} train step B={B} {label:22s}: {ms:.2f} ms/step, "
          f"{B / ms * 1e3:.2f} clips/s, peak memory {mem:.2f} GiB [{card}]")
    return ms


# sessions of torch.profiler that may record no device activity (seen on the
# card now and then, twice in a row once, six in a row once, ten in a row once)
# or lose kernels (ten in a row, fewer recorded each time, with the card's
# memory held by PyTorch's cache) before a measurement is given up; the waits
# between them double from 0.5 s up to 8 s, each after emptying the cache
PROFILE_ATTEMPTS = 10
# sessions a profile takes while the last one was given up, until one is read
PROFILE_ATTEMPTS_DOWN = 2
_profiler_down = False
# what the profiler could not read in this run (printed at the end): a
# breakdown or a profile-based check left out, or a device_ms taken by CUDA events
UNPROFILED: list = []


def _profile(fn, iters: int = 1):
    """fn under torch.profiler: (the profile, wall ms on the host clock to the
    synchronise), or (None, wall) when PROFILE_ATTEMPTS sessions in a row
    (PROFILE_ATTEMPTS_DOWN after a profile was given up) recorded no device
    activity or lost kernels (a kernel counted a number of times that
    `iters` calls of fn cannot give), each printed; fn runs again each time."""
    from torch.profiler import ProfilerActivity, profile

    global _profiler_down
    attempts = PROFILE_ATTEMPTS_DOWN if _profiler_down else PROFILE_ATTEMPTS
    unread = []
    for attempt in range(attempts):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        host = _host_keys(prof)
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host}
        if counts and all(c % iters == 0 for c in counts.values()):
            _profiler_down = False
            return prof, wall
        unread.append("no device activity" if not counts else
                      f"lost kernels {({k: c for k, c in counts.items() if c % iters})}")
        torch.cuda.empty_cache()
        time.sleep(min(8.0, 0.5 * 2 ** attempt))
    print(f"torch.profiler: {attempts} sessions unread: {unread}")
    _profiler_down = True
    return None, wall


def _profile_or_skip(fn, iters: int = 1, what: str = "a profile"):
    """_profile, and where it gives up, `what` noted as not measured."""
    prof, wall = _profile(fn, iters)
    if prof is None:
        UNPROFILED.append(what)
        print(f"torch.profiler: {what}: not measured")
    return prof, wall


def _host_keys(prof) -> set:
    """Names of the host ranges (a host range such as the optimizer's step also
    shows on the device timeline, over its kernels)."""
    return {e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU}


def profiled(fn, what: str) -> tuple[list | None, float]:
    """One call of fn under torch.profiler: ([(device us, kernel name, count)],
    wall ms on the host clock to the synchronise); None for the rows where
    the profiler gives up (_profile_or_skip)."""
    prof, wall = _profile_or_skip(fn, what=what)
    if prof is None:
        return None, wall
    host = _host_keys(prof)
    return [(getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0),
             e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host], wall


def kernel_timeline(fn, what: str, iters: int = 1) -> tuple[list | None, float]:
    """One call of fn (itself `iters` calls of something) under
    torch.profiler: ([(device us, kernel label)] in launch order, wall ms);
    None for the rows where the profiler gives up (_profile_or_skip). The
    label is the kernel's name without its arguments; a
    reduce_partials_kernel is labelled by the kernel whose partials it sums
    (wgrad's, or the LayerNorm backward's column partials)."""
    prof, wall = _profile_or_skip(fn, iters, what)
    if prof is None:
        return None, wall
    host = _host_keys(prof)
    events = sorted((e.time_range.start, e.self_device_time_total, e.name)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in host)
    rows, previous = [], ""
    for _, us, name in events:
        label = name[:name.rfind(">(") + 1] if ">(" in name else name.split("(")[0]
        label = label.replace("void ", "")
        if label.startswith("tvts::reduce_partials_kernel"):
            label += " (LayerNorm sums)" if "ln_bwd" in previous else " (wgrad sums)"
        else:
            previous = label
        rows.append((us, label))
    return rows, wall


def kernel_split(tag: str, label: str, fn, card: str, iters: int = 3) -> dict | None:
    """Device time and launches by kernel label (kernel_timeline) of one call
    of fn, averaged over `iters` calls after a warm-up call. Returns label ->
    (ms a call, launches a call), or None where the profiler gives up."""
    fn()
    rows, _ = kernel_timeline(lambda: [fn() for _ in range(iters)], f"[{tag}] split {label}",
                              iters)
    if rows is None:
        return None
    split = {}
    for us, name in rows:
        ms, n = split.get(name, (0.0, 0))
        split[name] = (ms + us / 1e3 / iters, n + 1)
    split = {k: (ms, n // iters) for k, (ms, n) in split.items()}
    busy = sum(ms for ms, _ in split.values())
    print(f"[{tag}] split {label}: device busy {busy:.3f} ms a call [{card}]")
    for name, (ms, n) in sorted(split.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}]   {ms:8.4f} ms {n:4d}x {name[:110]}")
    return split


def profile_kernels(tag: str, label: str, fn, card: str, top: int = 12) -> list | None:
    """Device time by CUDA kernel of one call of fn after a warm-up call, each
    kernel with its share of the call's device time. Returns the rows, or
    None where the profiler gives up."""
    fn()
    rows, wall = profiled(fn, f"[{tag}] profiled {label}")
    if rows is None:
        return None
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[{tag}] profiled {label}: device busy {busy:.3f} ms, wall {wall:.3f} ms [{card}]")
    for us, key, count in sorted(rows, reverse=True)[:top]:
        print(f"[{tag}]   {us / 1e3:9.3f} ms ({us / 1e3 / busy:.3f}) {count:5d}x {key[:100]}")
    return rows


# the LayerNorm backward's column sums in a step profile (kernel_timeline
# labels: the sums kernel, or the first version's reduction of its partials),
# and the most they may take in the B/16 step at B=20
LN_SUM_LABELS = ("tvts::ln_colsum_kernel", "tvts::reduce_partials_kernel (LayerNorm sums)")
LN_SUMS_MS = 0.5
# the backward kernels a step profile sums (every kernel_timeline label that
# starts with the name)
STEP_KERNELS = ("wgrad_kernel", "time_bwd_kernel", "space_bwd_kernel",
                "flash_bwd_dq_kernel<64, true>", "flash_bwd_dkv_kernel<64, true>",
                "flash_bwd_dq_kernel<80, true>", "flash_bwd_dkv_kernel<80, true>",
                "cls_grad_combine_kernel", "ln_bwd_kernel", "ln_colsum_kernel",
                "reduce_partials_kernel (LayerNorm sums)", "reduce_partials_kernel (wgrad sums)",
                "text_attn_fwd_kernel", "text_attn_fwd_small_kernel", "text_bwd_dq_kernel",
                "text_bwd_dkv_kernel", "text_bwd_small_kernel")
# the H7 cores before their redesign: a train step's profile may show none
OLD_H7_KERNELS = ("tvts::text_core_kernel", "tvts::flash_bwd_dq_kernel<64, false>",
                  "tvts::flash_bwd_dkv_kernel<64, false>", "tvts::flash_bwd_dq_kernel<80, false>",
                  "tvts::flash_bwd_dkv_kernel<80, false>")


def profile_step(tag: str, train: dict, apply_fn, batch, card: str) -> dict | None:
    """Device-time breakdown of one kernel-path train step (torch.profiler).
    Returns label -> (ms, launches) of the step's kernels, or None where the
    profiler gives up."""
    from tvts_torch.train.step import make_train_step

    B = batch["video"].shape[0]
    step = make_train_step(train["model"], train["optimizer"], train["ocfg"], apply_fn=apply_fn)
    what = f"[{tag}] profiled {train['cfg'].name} kernel-path step B={B}"
    rows, wall = kernel_timeline(lambda: step(batch), what)
    if rows is None:
        return None
    busy = sum(r[0] for r in rows) / 1e3
    print(f"[{tag}] profiled {train['cfg'].name} kernel-path step B={B}: wall {wall:.2f} ms, "
          f"device busy {busy:.2f} ms (idle share {max(0.0, 1 - busy / wall):.3f}) [{card}]")
    groups, by_label = {}, {}
    for us, key in rows:
        group = ("hand-written (tvts::)" if "tvts::" in key
                 else "optimizer (multi_tensor_apply)" if "multi_tensor_apply" in key
                 else "library GEMM (cuBLAS / CUTLASS)"
                 if any(k in key for k in ("nvjet", "gemm", "cutlass", "sm90_xmma"))
                 else "other PyTorch kernels (elementwise, reductions, copies, conv)")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        ms, n = by_label.get(key, (0.0, 0))
        by_label[key] = (ms + us / 1e3, n + 1)
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {ms:9.3f} ms ({ms / busy:.3f}) {group}")
    stale = [k for k in by_label if k.startswith(OLD_H7_KERNELS)]
    if stale:
        raise AssertionError(f"the step launched the H7 cores of the first design: {stale}")
    for name in STEP_KERNELS:
        rows = [v for k, v in by_label.items() if k.startswith("tvts::" + name)]
        print(f"[{tag}]   {sum(r[0] for r in rows):9.3f} ms in {sum(r[1] for r in rows)} "
              f"launches: every {name}")
    print(f"[{tag}]   top device time by kernel:")
    for key, (ms, n) in sorted(by_label.items(), key=lambda kv: -kv[1][0])[:24]:
        print(f"[{tag}]   {ms:9.3f} ms {n:5d}x {key[:100]}")
    return by_label


def backward_splits(dev, card: str, bb, ta) -> dict:
    """Each training backward that runs the LayerNorm backward or the space
    core, alone, split by kernel (kernel_split): H5 at the B/16 train shape
    (B=20, S=1177) and at the H/14 train shape (B=8, S=913, d=80), H7 at the
    B/16 text shape (B=80, S=77; full and frozen) and at the sort head's (B=20,
    S=1181). Returns label -> the split."""
    bk = bb.bk
    out = {}
    for label, (B, T, N, D, H) in (("H5 B/16 B=20", (20, 12, 98, 768, 12)),
                                   ("H5 H/14 B=8", (8, 12, 76, 1280, 16))):
        a = seeded_inputs(B, T, N, D, seed=14, device=dev)
        g = seeded_inputs(B, T, N, D, seed=15, device=dev)["x"]
        w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
        _, *saves = bk._attention_sub_path("tvts_space_core", a["x"], a["base"], *w, T, H,
                                           save=True)
        out[label] = kernel_split("6", f"{label} backward (space_subpath_backward)",
                                  lambda: bb.space_subpath_backward(
                                      g, a["x"], saves, a["ln_w"], a["ln_b"], a["wqkv"],
                                      a["wproj"], T, H), card)
        del a, g, saves
    for label, (B, S, D, H, causal, eps, frozen) in (
            ("H7 text B=80", (80, 77, 512, 8, True, 1e-5, False)),
            ("H7 text frozen B=80", (80, 77, 512, 8, True, 1e-5, True)),
            ("H7 sort B=20", (20, 1181, 512, 8, False, 1e-6, False))):
        t = text_inputs(B, S, D, seed=16, device=dev)
        tg = text_inputs(B, S, D, seed=17, device=dev)["x"]
        tw = (t["ln_w"], t["ln_b"], t["wqkv"], t["bqkv"], t["wproj"], t["bproj"])
        _, *saves = ta._text_sub_path(t["x"], *tw, H, causal, eps, save=True)
        out[label] = kernel_split("6", f"{label} backward (text_subpath_backward)",
                                  lambda: ta.text_subpath_backward(
                                      tg, t["x"], saves, t["ln_w"], t["ln_b"], t["wqkv"],
                                      t["wproj"], H, causal, frozen), card)
        del t, tg, saves
    return out


def train_times(dev, card, bk, bb, ta, ac, train: dict, times: dict, library: dict) -> None:
    """Phase 6, train part: the step at B=20 (kernels, kernels with H8, eager),
    each backward against its plain backward, the saving forwards, H8 and H9
    against their plain versions at the B=20 shapes, the profiler breakdown of
    one step."""
    cfg = train["cfg"]
    v, B = cfg.vision, 20
    batch = train_batch(cfg, B, seed=13, device=dev)
    for label, apply_fn in (("kernels", train["kernel_apply"]),
                            ('kernels mlp_mode="pallas"', train["mlp_apply"]),
                            ("eager", None)):
        time_steps("6", label, train, apply_fn, batch, card)
    step = profile_step("6", train, train["kernel_apply"], batch, card)
    if step is None:
        UNPROFILED.append(f"[6] the LayerNorm column sums' target (<= {LN_SUMS_MS} ms)")
    else:
        sums = [v for k, v in step.items() if k.startswith(LN_SUM_LABELS)]
        sums_ms = sum(ms for ms, _ in sums)
        print(f"[6] the LayerNorm column sums of the B/16 step B={B}: {sums_ms:.3f} ms in "
              f"{sum(n for _, n in sums)} launches (target <= {LN_SUMS_MS} ms) [{card}]")
        if sums_ms > LN_SUMS_MS:
            raise AssertionError(f"the LayerNorm sums of a B/16 step take {sums_ms:.3f} ms, "
                                 f"more than {LN_SUMS_MS}")

    S = 1 + v.num_frames * v.n_keep
    T, N, D, H = v.num_frames, v.n_keep, v.width, v.heads
    a = seeded_inputs(1, 1, 1, D, seed=14, device=dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    for k in ("x", "base"):
        a[k] = torch.randn(B, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
    g = torch.randn(B, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
    w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
    for kind, core in (("time", "tvts_time_core"), ("space", "tvts_space_core")):
        name = f"{kind}_subpath_backward"
        res = a["x"] if kind == "time" else a["base"]
        with torch.inference_mode():  # the training forward, keeping its saves
            k_ms = cuda_ms(lambda: bk._attention_sub_path(core, a["x"], res, *w, T, H, save=True),
                           iters=5)
            plain_fwd = bk.time_block_plain if kind == "time" else bk.space_block_plain
            extra = (a["base"],) if kind == "space" else ()
            p_ms = cuda_ms(lambda: plain_fwd(a["x"], *extra, *w, T, H), iters=3)
        times[f"{kind}_subpath"] = (k_ms, p_ms, bound_ms(*saving_forward_work(kind, B, T, N, D, H)))
        print(f"[6] {kind}_subpath (saving forward) B={B} S={S}: kernel {k_ms:.3f} ms, plain "
              f"forward {p_ms:.3f} ms, bound {times[f'{kind}_subpath'][2][0]:.3f} ms "
              f"({times[f'{kind}_subpath'][2][1]}) [{card}]")
        _, *saves = bk._attention_sub_path(core, a["x"], res, *w, T, H, save=True)
        fn = getattr(bb, name)
        k_ms = cuda_ms(lambda: fn(g, a["x"], saves, a["ln_w"], a["ln_b"], a["wqkv"],
                                  a["wproj"], T, H), iters=5)
        plain = bb.time_subpath_backward_plain if kind == "time" \
            else bb.space_subpath_backward_plain
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
    mlp_times("6", card, bk, bb, a, g, v.act, times)
    for mode in ("space", "time"):
        qkv = core_inputs(B, T, N, H, D // H, 19, dev)
        kernel, plain = core_calls(ac, qkv, T, N, mode)
        one_call = core_library_call(qkv, T, N, mode)
        with torch.inference_mode():
            k_ms, p_ms = cuda_ms(kernel, iters=10), cuda_ms(plain, iters=5)
            l_ms = cuda_ms(one_call, iters=10)
            diff, ref, tol = core_band_check(one_call(), plain())
        if diff > tol:
            raise AssertionError(f"the masked library call is not H9 {mode}: max|diff| {diff}")
        bnd = bound_ms(*core_work(mode, B, T, N, H, D // H))
        if mode == "space":  # the mode the towers run (use_pallas=True)
            times["divided_space_time_attention_fused"] = (k_ms, p_ms, bnd)
            library["divided_space_time_attention_fused"] = l_ms
        print(f"[6] divided_space_time_attention_fused {mode} B={B} N={N} d={D // H}: kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, masked scaled_dot_product_attention "
              f"{l_ms:.3f} ms (max|diff| to plain {diff:.5f}, tol {tol:.5f}), bound "
              f"{bnd[0]:.3f} ms ({bnd[1]}) [{card}]")


# H9 in f32 at the shape of phase 4's f32 use_pallas tower and at H/14's
# frame: (B, T, N, H, d)
CORE_F32_SHAPES = {"B/16 tower": (8, 12, 196, 12, 64), "H/14 frame": (4, 12, 256, 16, 80)}


def core_f32_bounds(mode: str, B: int, T: int, N: int, H: int, d: int) -> dict:
    """H9's least times in f32 (bytes at 4 B an element against the
    operations): the operations at the f32 FMA rate ("f32 FMA") and as three
    TF32 tensor-core products ("3xTF32"), each (ms, bound_by)."""
    flops, nbytes = core_work(mode, B, T, N, H, d, elem=4)
    return {"f32 FMA": bound_ms(flops, nbytes, PEAK_F32_FLOPS),
            "3xTF32": bound_ms(3 * flops, nbytes, PEAK_TF32_FLOPS)}


def core_f32_times(dev, card: str, ac, times: dict, library: dict) -> None:
    """H9 on f32 q, k, v, space and time, against plain f32 and one masked
    f32 scaled_dot_product_attention (`library_ms`), beside both bounds; the
    kernels line takes the bound of the route each core runs (space: three
    TF32 products, time: f32 FMA) at the f32 tower's shape."""
    name = "divided_space_time_attention_fused (f32"
    for label, (B, T, N, H, d) in CORE_F32_SHAPES.items():
        qkv = core_inputs(B, T, N, H, d, 19, dev, dtype=torch.float32)
        for mode in ("space", "time"):
            kernel, plain = core_calls(ac, qkv, T, N, mode)
            one_call = core_library_call(qkv, T, N, mode)
            with torch.inference_mode(), no_tf32():
                k_ms, p_ms = cuda_ms(kernel, iters=20), cuda_ms(plain, iters=3)
                l_ms = cuda_ms(one_call, iters=10)
                diff, ref, tol = core_band_check(one_call(), plain())
            if diff > tol:
                raise AssertionError(f"the masked f32 library call is not H9 {mode}: max|diff| "
                                     f"{diff}")
            bounds = core_f32_bounds(mode, B, T, N, H, d)
            if label == "B/16 tower":
                key = f"{name})" if mode == "space" else f"{name} time)"
                route = bounds["3xTF32" if mode == "space" else "f32 FMA"]
                times[key], library[key] = (k_ms, p_ms, route), l_ms
            print(f"[6] {name}) {mode} {label} B={B} N={N} H={H} d={d}: kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.3f} ms, masked f32 scaled_dot_product_attention {l_ms:.3f} ms "
                  f"(max|diff| to plain {diff:.2e}), bounds "
                  + ", ".join(f"{k} {b[0]:.4f} ms ({b[1]})" for k, b in bounds.items())
                  + f" (f32 at {PEAK_F32_FLOPS / 1e12:.0f}, TF32 at "
                  f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, 4 bytes an element) [{card}]")
        del qkv
        torch.cuda.empty_cache()


# mma.sync throughput probe: each warp issues 8 independent m16n8k8 TF32 (or
# m16n8k16 bf16) products `iters` times from registers; the rate that bounds
# a kernel on mma.sync (the f32 H9 space core: three TF32 products a step)
MMA_PROBE = r"""
#include <cstdint>
template <int BF16>
__global__ void mma_probe(float* out, int iters) {
  float c[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b0 = threadIdx.x * 11u, b1 = threadIdx.x * 13u;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(c[i][0]), "+f"(c[i][1]), "+f"(c[i][2]), "+f"(c[i][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  float s = 0.f;
  for (int i = 0; i < 8; ++i) s += c[i][0] + c[i][1] + c[i][2] + c[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_probe_launch(int bf16, int blocks, int threads, float* out, int iters) {
  if (bf16) mma_probe<1><<<blocks, threads>>>(out, iters);
  else mma_probe<0><<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_sync_rates(dev, card: str, bk) -> dict:
    """TFLOP/s of mma.sync m16n8k8 TF32 and m16n8k16 bf16 at 8 warps an SM
    (two blocks of 4 on each SM, 4096 iterations of 8 products a warp), by
    CUDA events; the probe is built with the kernels' nvcc into a temporary
    directory."""
    import ctypes
    import tempfile

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads, iters = 2 * sms, 128, 4096
    out = torch.empty(blocks * threads, device=dev)
    rates = {}
    with tempfile.TemporaryDirectory(prefix="tvts_mma_probe_") as tmp:
        src, so = Path(tmp) / "probe.cu", Path(tmp) / "probe.so"
        src.write_text(MMA_PROBE)
        subprocess.run([bk._nvcc(), *bk._NVCC_FLAGS[:4], "-Xcompiler", "-fPIC", "-shared",
                        "-o", str(so), str(src)], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        for kind, k in (("tf32 m16n8k8", 8), ("bf16 m16n8k16", 16)):
            launch = lambda: lib.mma_probe_launch(int(k == 16), blocks, threads,
                                                  ctypes.c_void_p(out.data_ptr()), iters)
            ms = cuda_ms(launch, iters=3)
            rates[kind] = 2 * 16 * 8 * k * 8 * iters * blocks * threads / 32 / (ms * 1e-3) / 1e12
            print(f"[6] mma.sync {kind}: {rates[kind]:.1f} TFLOP/s at 8 warps an SM [{card}]")
    return rates


def mlp_times(tag: str, card: str, bk, bb, a: dict, g, act: str, times: dict | None) -> None:
    """H8 forward and backward, recomputing and saving, against plain, on the
    inputs a["x"] and the output gradient g."""
    B, S, D = a["x"].shape
    w = (a["ln_w"], a["ln_b"], a["wfc"], a["bfc"], a["wpr"], a["bpr"])
    p_fwd = p_bwd = None
    for save in (False, True):
        form = "saved hidden" if save else "recomputing"
        with torch.inference_mode():
            k_ms = cuda_ms(lambda: bk._mlp_sub_path(a["x"], *w, act, save_hidden=save), iters=5)
            p_fwd = p_fwd or cuda_ms(lambda: bk.mlp_block_plain(a["x"], *w, act), iters=5)
        bnd = bound_ms(*mlp_work(B * S, D, False, save))
        print(f"[{tag}] mlp_subpath forward ({form}) B={B} S={S} D={D} {act}: kernel "
              f"{k_ms:.3f} ms, plain {p_fwd:.3f} ms, bound {bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
        suffix = " (saved hidden)" if save else ""
        if times is not None:
            times["mlp_subpath" + suffix] = (k_ms, p_fwd, bnd)
        _, stats, h = bk._mlp_sub_path(a["x"], *w, act, save_hidden=save)
        k_ms = cuda_ms(lambda: bb.mlp_subpath_backward(g, a["x"], stats, h, a["ln_w"], a["ln_b"],
                                                       a["wfc"], a["bfc"], a["wpr"], act),
                       iters=5)
        p_bwd = p_bwd or cuda_ms(lambda: bb.mlp_subpath_backward_plain(g, a["x"], *w, act),
                                 iters=3)
        bnd = bound_ms(*mlp_work(B * S, D, True, save))
        print(f"[{tag}] mlp_subpath_backward ({form}) B={B} S={S} D={D} {act}: kernel "
              f"{k_ms:.3f} ms, plain {p_bwd:.3f} ms (forward + backward), bound {bnd[0]:.3f} ms "
              f"({bnd[1]}) [{card}]")
        if times is not None:
            times["mlp_subpath_backward" + suffix] = (k_ms, p_bwd, bnd)
        del h


def ln_gemm_products(cfg) -> list[dict]:
    """Every ln_gemm product shape of the extraction forward at B=64 clips and
    of the train step at B=20 (the forwards, the backwards' dx products, the
    text and sort-head attention) of the training config `cfg` (its n_keep
    patches a frame in the step, all of them in extraction): name, M, N, K,
    A's row stride, LayerNorm prologue (its eps) or none, epilogue."""
    B, TB = 64, 20
    v, tc, sort = cfg.vision, cfg.text, cfg.sort
    D, Dt, Ds = v.width, tc.width, sort.embed_dim
    S = 1 + v.num_frames * v.patches_per_frame
    Me, Mt = B * S, TB * (1 + v.num_frames * v.n_keep)
    Mx, Ms = TB * cfg.num_clips * tc.context_length, TB * (Mt // TB + cfg.num_clips)
    ln, act = 1e-5, v.act

    def p(name, M, N, K, eps=None, epi="bias", lda=None):
        return dict(name=name, M=M, N=N, K=K, lda=lda or K, ln=eps, epi=epi,
                    act=act if act in epi or "act_grad" in epi else "none")

    return [
        p("extraction qkv (H1, H2)", Me, 3 * D, D, ln),
        p("extraction proj (H1, H2)", Me, D, D, epi="bias+residual"),
        p("extraction c_fc (H3)", Me, 4 * D, D, ln, epi=f"bias+{act}"),
        p("extraction c_proj (H3)", Me, D, 4 * D, epi="bias+residual"),
        p("step qkv (H5, H6)", Mt, 3 * D, D, ln),
        p("step proj (H5, H6)", Mt, D, D, epi="bias+residual"),
        p("step dattn = g Wproj (H5, H6)", Mt, D, D, epi="none"),
        p("step dxln = dqkv Wqkv (H5, H6)", Mt, D, 3 * D, epi="f32"),
        p("step c_fc saving h (H8)", Mt, 4 * D, D, ln, epi=f"bias+{act}+save"),
        p("step h = c_fc f32 (H8 backward)", Mt, 4 * D, D, ln, epi="bias+f32"),
        p("step dh = g Wproj * act'(h bf16) (H8)", Mt, 4 * D, D, epi="act_grad_bf16"),
        p("step dh = g Wproj * act'(h f32) (H8)", Mt, 4 * D, D, epi="act_grad_f32"),
        p("step dxln = dh Wfc (H8)", Mt, D, 4 * D, epi="f32"),
        p("step text qkv (H7)", Mx, 3 * Dt, Dt, ln),
        p("step text proj (H7)", Mx, Dt, Dt, epi="bias+residual"),
        p("step text dxln (H7)", Mx, Dt, 3 * Dt, epi="f32"),
        p("step sort qkv (H7)", Ms, 3 * Ds, Ds, 1e-6),
        p("step sort dxln (H7)", Ms, Ds, 3 * Ds, epi="f32"),
    ]


def joint_gemm_products(B: int = 15) -> list[dict]:
    """The four ln_gemm products of a VideoMAE V2 ViT-g/14 joint block
    (downstream/model.vit_giant_patch14_224: 1408 wide, an MLP of 6144, 2,048
    tokens a clip, LayerNorm eps 1e-6, exact GELU) at B clips, as the
    g14.classify cell runs them: K = 1408 in 22 k-steps, and qkv's N = 4224
    ends in half a 256-column tile. Keys as ln_gemm_products'."""
    M, D, hidden, eps = B * 2048, 1408, 6144, 1e-6

    def p(name, N, K, ln=None, epi="bias"):
        return dict(name=name, M=M, N=N, K=K, lda=K, ln=ln, epi=epi,
                    act="gelu" if "gelu" in epi else "none")

    return [p(f"ViT-g qkv (joint attention) B={B}", 3 * D, D, eps),
            p(f"ViT-g proj (joint attention) B={B}", D, D, epi="bias+residual"),
            p(f"ViT-g fc1 (H3) B={B}", hidden, D, eps, epi="bias+gelu"),
            p(f"ViT-g fc2 (H3) B={B}", D, hidden, epi="bias+residual")]


def small_gemm_products() -> list[dict]:
    """ln_gemm products of fewer tiles than the H100's 132 SMs, where the
    persistent grid runs one tile a block: the B/16 text tower's qkv and proj
    at one caption (77 rows), one block of 64 CLS rows through qkv, and c_fc /
    c_proj at 1,280 and 5,504 rows (120 and 129 tiles). Keys as
    ln_gemm_products'."""
    def p(name, M, N, K, ln=None, epi="bias", act="none"):
        return dict(name=name, M=M, N=N, K=K, lda=K, ln=ln, epi=epi, act=act)

    return [p("small: text qkv, one caption (H7)", 77, 1536, 512, 1e-5),
            p("small: text proj, one caption (H7)", 77, 512, 512, epi="bias+residual"),
            p("small: qkv of 64 CLS rows", 64, 2304, 768, 1e-5),
            p("small: c_fc M=1280 (H3)", 1280, 3072, 768, 1e-5, "bias+quick_gelu",
              "quick_gelu"),
            p("small: c_proj M=5504 (H3)", 5504, 768, 3072, epi="bias+residual")]


def gemm_plain(a, w, bias, act: str, kw: dict) -> list[torch.Tensor]:
    """ln_gemm's outputs (out, then pre or act_out) in plain f32 torch from
    the same bf16 operands, A = LN(x) already rounded as the row pass rounds
    it: bias, activation (from the bf16-rounded pre-activation when it is
    saved), residual; under an act' epilogue (a `hidden` in kw) the product
    times act'(hidden) and act(hidden)."""
    from tvts_torch.models.layers import get_activation

    y = torch.nn.functional.linear(a.float(), w.float())
    fn = (lambda t: t) if act == "none" else get_activation(act)
    if "hidden" in kw:
        h = kw["hidden"].float().requires_grad_()
        ah = fn(h)
        (dh,) = torch.autograd.grad(ah, h, y) if act != "none" else (y,)
        return [dh, ah.detach()]
    if bias is not None:
        y += bias.float()
    if "pre" in kw:
        return [fn(y.bfloat16().float()), y]
    y = fn(y)
    if "res" in kw:
        y += kw["res"].float()
    return [y]


def gemm_fit(rows: list[dict], sms: int) -> dict:
    """The per-tile fixed cost and the per-k-step cost of ln_gemm, fitted to
    the B/16 extraction's proj (K = 768) and c_proj (K = 3072), which share M
    = 150,592, N = 768 and the residual epilogue: a block's walk of
    ceil(tiles / SMs) tiles takes fixed + K / 64 * step microseconds a tile."""
    by = {r["name"]: r for r in rows}
    a, b = by["extraction proj (H1, H2)"], by["extraction c_proj (H3)"]
    waves = -(-(-(-a["N"] // 256) * -(-a["M"] // 128)) // sms)
    ta, tb = (1000 * r["ms"] / waves for r in (a, b))
    step = (tb - ta) / ((b["K"] - a["K"]) // 64)
    return dict(waves=waves, tile_us=(ta, tb), step_us=step,
                fixed_us=ta - a["K"] // 64 * step)


def wgrad_products(cfg, B: int) -> list[dict]:
    """Every weight-gradient product (wgrad) of one train step at B clips of
    the training config `cfg` (its n_keep patches a frame): C [N1, N2] = A^T
    B over M rows, B being LN(x) (with its eps) for the products that follow
    a LayerNorm: the video attention blocks (H5, H6), the video MLP (H8,
    mlp_mode="pallas"), the unfrozen text blocks and the sort head (H7)."""
    v, tc, sort = cfg.vision, cfg.text, cfg.sort
    D, Dt, Ds = v.width, tc.width, sort.embed_dim
    hidden = int(D * v.mlp_ratio)
    Mt = B * (1 + v.num_frames * v.n_keep)
    Mx, Ms = B * cfg.num_clips * tc.context_length, B * (Mt // B + cfg.num_clips)

    def p(name, M, N1, N2, eps=None):
        return dict(name=name, M=M, N1=N1, N2=N2, ln=eps)

    return [
        p("dWproj (H5, H6)", Mt, D, D),
        p("dWqkv (H5, H6)", Mt, 3 * D, D, 1e-5),
        p("dWproj = g^T act (H8)", Mt, D, hidden),
        p("dWfc (H8)", Mt, hidden, D, 1e-5),
        p("text dWproj (H7)", Mx, Dt, Dt),
        p("text dWqkv (H7)", Mx, 3 * Dt, Dt, 1e-5),
        p("sort dWproj (H7)", Ms, Ds, Ds),
        p("sort dWqkv (H7)", Ms, 3 * Ds, Ds, 1e-6),
    ]


def ln_gemm_table(dev, card: str, bk) -> list[dict]:
    """Each B/16 product of ln_gemm_products, then the ViT-g joint block's
    (joint_gemm_products), then the small ones (small_gemm_products), through
    ln_gemm on seeded operands: ms (CUDA events over 5 launches, 100 below
    0.1 TFLOP a launch, where a launch takes microseconds), TFLOP/s, its bound
    (operands read once, outputs written once), as library_ms one
    torch.nn.functional.linear on the same A, W and bias (the product alone;
    timed here only, never called by the port), the output tiles and
    persistent blocks of one launch (`gemm_counts`) with the share of tiles
    that followed another tile in their block (1 - blocks / tiles: the tiles
    whose start can overlap an epilogue; whether it does shows in the fit),
    and the sha256 of each output (equal digests: bit-identical outputs; a
    run over another tree's tvts_torch gives that tree's, see PERF.md). Every
    output is held to plain torch (gemm_plain) within the H1-H3 band
    (band_check), every column of a partial last tile included. Prints the
    fit of gemm_fit as {"ln_gemm_fit": ...}."""
    from tvts_torch.models.configs import tvtsv2_b_16

    lib = bk.library()
    gen = torch.Generator(device=dev).manual_seed(31)
    bf = torch.bfloat16
    rows = []
    for p in ln_gemm_products(tvtsv2_b_16()) + joint_gemm_products() + small_gemm_products():
        M, N, K, epi = p["M"], p["N"], p["K"], p["epi"]
        x = torch.randn(M, p["lda"], generator=gen, device=dev, dtype=bf)
        w = torch.randn(N, K, generator=gen, device=dev, dtype=bf) * K ** -0.5
        b = 0.1 * torch.randn(N, generator=gen, device=dev, dtype=bf)
        f32 = "f32" in epi and "act_grad" not in epi
        out = torch.empty(M, N, device=dev, dtype=torch.float32 if f32 else bf)
        ln = (1 + 0.1 * torch.randn(K, generator=gen, device=dev),
              0.1 * torch.randn(K, generator=gen, device=dev)) if p["ln"] else None
        kw = dict(act=p["act"], eps=p["ln"] or bk.LN_EPS)
        extra = 0
        if "residual" in epi:
            kw.update(res=torch.randn(M, N, generator=gen, device=dev, dtype=bf), ldres=N)
            extra += 2 * M * N
        if "save" in epi:
            kw["pre"] = torch.empty_like(out)
            extra += 2 * M * N
        if "act_grad" in epi:
            hdt = torch.float32 if epi.endswith("f32") else bf
            kw.update(hidden=torch.randn(M, N, generator=gen, device=dev, dtype=hdt),
                      act_out=torch.empty_like(out))
            extra += (4 if hdt == torch.float32 else 2) * M * N + 2 * M * N
        bias = None if epi in ("none", "f32") or "act_grad" in epi else b
        flops = 2 * M * N * K
        ms = cuda_ms(lambda: bk._ln_gemm(lib, x, M, p["lda"], ln, w, bias, out, **kw),
                     iters=5 if flops > 1e11 else 100)
        counts = getattr(bk, "gemm_counts", lambda: {"tiles": None, "blocks": None})
        before = counts()
        bk._ln_gemm(lib, x, M, p["lda"], ln, w, bias, out, **kw)
        tiles, blocks = (None if n is None else n - before[k] for k, n in counts().items())
        digests = [sha256_of(t) for t in (out, kw.get("pre"), kw.get("act_out"))
                   if t is not None]
        a2 = x[:, :K]
        lib_ms = cuda_ms(lambda: torch.nn.functional.linear(a2, w, bias), iters=5)
        a = bk.ln_rows_plain(a2, *ln, p["ln"])[0] if ln else a2
        outs = [t for t in (out, kw.get("pre"), kw.get("act_out")) if t is not None]
        for got, want in zip(outs, gemm_plain(a, w, bias, p["act"], kw)):
            diff, mean, tol = band_check(got, want)
            print(f"[6] ln_gemm {p['name']}: max|diff| {diff:.5f} mean|ref| {mean:.4f} "
                  f"(tol {tol:.4f}) against plain")
            if diff > tol:
                raise AssertionError(f"ln_gemm {p['name']}: {diff} > {tol}")
            del want
        del a
        nbytes = 2 * M * K + 2 * N * K + out.element_size() * M * N + extra
        bnd = bound_ms(flops, nbytes)
        rows.append(dict(name=p["name"], M=M, N=N, K=K,
                         prologue=f"layernorm eps {p['ln']:g}" if p["ln"] else "none",
                         epilogue=epi, ms=ms, tflops=flops / ms / 1e9, bound_ms=bnd[0],
                         bound_by=bnd[1], library_ms=lib_ms, tiles=tiles, blocks=blocks,
                         overlap_share=1 - blocks / tiles if tiles else None,
                         sha256=digests))
        print(f"[6] ln_gemm {p['name']:40s} M={M} N={N} K={K}: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s, bound {bnd[0]:.3f} ms ({bnd[1]}), "
              f"F.linear {lib_ms:.3f} ms, {tiles} tiles over {blocks} blocks, sha256 "
              f"{' '.join(d[:16] for d in digests)} [{card}]")
        del x, out, kw
    fit = gemm_fit(rows, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(json.dumps({"ln_gemm_fit": fit}))
    return rows


def ln_gemm_phase(dev, card: str, bk, args: list[str]) -> int:
    """`--ln-gemm OUT.json [AGAINST.json ...]`: the ln_gemm table alone,
    written to OUT.json, and each row's rate beside those of the tables
    AGAINST (the same script run over another tree of the port: copy it
    there and run it from there). Returns 1 when a digest differs."""
    rows = ln_gemm_table(dev, card, bk)
    with open(args[0], "w") as f:
        json.dump(rows, f)
    others = [json.load(open(path)) for path in args[1:]]
    bad = 0
    for i, r in enumerate(rows):
        same = all(o[i]["name"] == r["name"] and o[i]["sha256"] == r["sha256"] for o in others)
        bad += not same
        print(f"[6] ln_gemm {r['name']:40s} {r['tflops']:.1f} TFLOP/s against "
              + ", ".join(f"{o[i]['tflops']:.1f}" for o in others)
              + f"; digests {'equal' if same else 'DIFFER'} [{card}]")
    print(f"[6] ln_gemm: {bad} of {len(rows)} rows with another digest")
    return 1 if bad else 0


def ln_rows_table(dev, card: str, bk) -> list[dict]:
    """The LayerNorm row pass alone at the extraction shapes (B/16 at B=48
    and B=64, H/14 at B=24): ms (CUDA events), its byte bound (x read once,
    LN(x) written once in bf16, the statistics and parameters once) and the
    share of the HBM rate it reaches."""
    from tvts_torch.models.configs import tvtsv2_b_16, tvtsv2_h_14

    gen = torch.Generator(device=dev).manual_seed(32)
    rows = []
    for name, cfg, B in (("B/16", tvtsv2_b_16(), 48), ("B/16", tvtsv2_b_16(), 64),
                         ("H/14", tvtsv2_h_14(), 24)):
        v = cfg.vision
        M, K = B * (1 + v.num_frames * v.patches_per_frame), v.width
        x = torch.randn(M, K, generator=gen, device=dev, dtype=torch.bfloat16)
        w = 1 + 0.1 * torch.randn(K, generator=gen, device=dev)
        b = 0.1 * torch.randn(K, generator=gen, device=dev)
        ms = cuda_ms(lambda: bk.ln_rows(x, w, b), iters=20)
        bnd, _ = bound_ms(0, 4 * M * K + 8 * M + 8 * K)
        rows.append(dict(name=f"{name} B={B}", M=M, K=K, ms=ms, bound_ms=bnd,
                         hbm_share=bnd / ms))
        print(f"[6] ln_rows {name} B={B} M={M} K={K}: {ms:.4f} ms, bound {bnd:.4f} ms "
              f"(bytes), {100 * bnd / ms:.1f}% of the HBM rate [{card}]")
        del x
    return rows


def device_ms(fn, iters: int = 10) -> float:
    """Device time of fn's CUDA kernels per call (torch.profiler), after a
    warm-up: the host's launch overhead, which CUDA events around a short
    function would count, left out. Where the profiler gives up (_profile),
    CUDA events around `iters` calls back to back (cuda_ms), which may count
    some of that overhead; noted in UNPROFILED and printed."""
    for _ in range(2):
        fn()
    prof, _ = _profile(lambda: [fn() for _ in range(iters)], iters)
    if prof is None:
        ms = cuda_ms(fn, iters, warmup=0)
        UNPROFILED.append(f"device_ms: {ms:.4f} ms by CUDA events (the next line's)")
        print(f"torch.profiler: device_ms by CUDA events instead: {ms:.4f} ms a call")
        return ms
    host = _host_keys(prof)
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in host) / 1e3 / iters


def wgrad_operands(M: int, N1: int, N2: int, ln, gen, dev) -> tuple:
    """a [M, N1] and b [M, N2] bf16 (b offset to a LayerNorm's scale), and
    with a LayerNorm eps the row statistics of b and its parameters."""
    bf = torch.bfloat16
    a = torch.randn(M, N1, generator=gen, device=dev, dtype=bf)
    b = torch.randn(M, N2, generator=gen, device=dev, dtype=bf) + 0.5
    if ln is None:
        return a, b, None, None
    bf32 = b.float()
    stats = torch.stack([bf32.mean(-1), torch.rsqrt(bf32.var(-1, unbiased=False) + ln)], -1)
    return a, b, stats, (1 + 0.1 * torch.randn(N2, generator=gen, device=dev),
                         0.1 * torch.randn(N2, generator=gen, device=dev))


def wgrad_table(dev, card: str, bb) -> tuple[list[dict], dict]:
    """Each weight-gradient product of the B/16 step at B=20 and of the H/14
    step at B=8 (wgrad_products) through wgrad on seeded operands: ms (device
    time, device_ms; the partials' reduction included), TFLOP/s, its bound (operands
    read once, dW and db written once in bf16) and as library_ms one
    torch.matmul(a.t(), b) on the same bf16 operands (for the LayerNorm
    products on the pre-normalised b; timed here only, never called by the
    port). Every product is held against wgrad_plain (LN(b) rounded as the
    kernel rounds it): each element within one bf16 unit in the last place of
    it plus 1e-5 * max|ref|, where the f32 summation order decides. Returns
    (rows, the B/16 dWqkv row's kernel-line numbers)."""
    from tvts_torch.models.configs import tvtsv2_b_16, tvtsv2_h_14

    gen = torch.Generator(device=dev).manual_seed(33)
    rows, line = [], None
    for arch, cfg, B in (("B/16", tvtsv2_b_16(), 20), ("H/14", tvtsv2_h_14(), 8)):
        for p in wgrad_products(cfg, B):
            M, N1, N2 = p["M"], p["N1"], p["N2"]
            a, b, stats, ln = wgrad_operands(M, N1, N2, p["ln"], gen, dev)
            ms = device_ms(lambda: bb.wgrad(a, b, stats, ln))
            lib_ms = device_ms(lambda: torch.matmul(a.t(), b))
            got = bb.wgrad(a, b, stats, ln)
            torch.cuda.synchronize()
            want = bb.wgrad_plain(a, b, stats, ln, dtype=torch.float32)
            err = 0.0
            for g, w in zip(got, want):
                diff = (g.float() - w).abs()
                unit = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(1e-30))) - 7)
                if (diff > unit + 1e-5 * w.abs().max()).any():
                    raise AssertionError(f"wgrad {arch} {p['name']}: off plain by more than "
                                         f"one bf16 unit (max|diff| {diff.max().item()})")
                err = max(err, diff.max().item())
            flops = 2 * M * N1 * N2
            bnd = bound_ms(flops, 2 * M * (N1 + N2) + 2 * (N1 * N2 + N1))
            rows.append(dict(name=f"{arch} {p['name']}", M=M, N1=N1, N2=N2,
                             prologue=f"layernorm eps {p['ln']:g}" if p["ln"] else "none",
                             ms=ms, tflops=flops / ms / 1e9, bound_ms=bnd[0], bound_by=bnd[1],
                             library_ms=lib_ms, max_abs_err=err))
            print(f"[6] wgrad {arch} {p['name']:24s} M={M} N1={N1} N2={N2} "
                  f"{'LN' if p['ln'] else '  '}: {ms:.3f} ms, {flops / ms / 1e9:.1f} TFLOP/s, "
                  f"bound {bnd[0]:.3f} ms ({bnd[1]}), torch.matmul {lib_ms:.3f} ms "
                  f"({ms / lib_ms:.2f}x), max|diff| to plain {err:.3e} [{card}]")
            if arch == "B/16" and p["name"].startswith("dWqkv"):
                p_ms = device_ms(lambda: bb.wgrad_plain(a, b, stats, ln), iters=3)
                line = dict(ms=ms, plain_ms=p_ms, bound=bnd, library_ms=lib_ms, max_abs_err=err)
            del a, b, stats, got, want
    return rows, line


def time_bwd_work(B: int, T: int, N: int, H: int, d: int) -> tuple[float, float]:
    """(flops, bytes) of the backward time core: per (clip, location, head)
    G = T + 1 elements, 10 * d * G^2 flops (the logits and dP, dq, dk and dv);
    qkv and dO read once with the lse and delta, dqkv written once."""
    S, D, G = 1 + T * N, H * d, T + 1
    return 10 * d * G * G * B * N * H, 2 * B * S * (3 * D + D + 3 * D) + 8 * B * H * S


def time_core_bwd_inputs(B, T, N, H, d, seed, dev, bb):
    """Seeded qkv and dO (bf16) and the lse and delta of the plain core."""
    rng = np.random.default_rng(seed)
    S, D = 1 + T * N, H * d
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * D)), dtype=torch.bfloat16, device=dev)
    dO = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.bfloat16, device=dev)
    out, lse = bb.time_core_plain(qkv, T, H)
    delta = (dO.float() * out).reshape(B, S, H, d).sum(-1).transpose(1, 2).contiguous()
    return qkv, dO, lse.contiguous(), delta


def time_core_bwd_digests(dev, bb) -> None:
    """The backward time core at the B/16 (N = 98, d = 64) and H/14 (N = 76,
    d = 80) train shapes: the sha256 of its dqkv and of the groups' CLS
    partials (equal digests in two trees: bit-identical outputs)."""
    import hashlib

    for B, T, N, H, d in ((2, 12, 98, 12, 64), (1, 12, 76, 16, 80)):
        qkv, dO, lse, delta = time_core_bwd_inputs(B, T, N, H, d, 53, dev, bb)
        with torch.cuda.device(dev):
            dqkv, partial = bb._time_core_backward(bb.bk.library(), qkv, dO, lse, delta, T, H)
        torch.cuda.synchronize()
        for name, t in (("dqkv", dqkv.view(torch.int16)), ("CLS partials", partial)):
            digest = hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()
            print(f"[6] time core backward N={N} d={d}: {name} sha256 {digest}")


def time_core_bwd_times(dev, card: str, bb, B: int = 20) -> dict:
    """The backward time core alone at the B/16 step shape (B clips, S =
    1177, d = 64), the CLS combine included (device time, device_ms), against
    its byte bound, the plain backward and one masked
    scaled_dot_product_attention backward (library_ms); held against the
    plain backward (each element within the bf16 store plus 1e-4 *
    max|ref|). Returns the kernel line's numbers."""
    T, N, H, d = 12, 98, 12, 64
    qkv, dO, lse, delta = time_core_bwd_inputs(B, T, N, H, d, 54, dev, bb)
    ms = device_ms(lambda: bb.time_core_backward(qkv, dO, lse, delta, T, H))
    p_ms = device_ms(lambda: bb.time_core_backward_plain(qkv, dO, lse, delta, T, H), iters=3)
    l_ms = device_ms(core_backward_library_call(qkv, dO, T, H, "time"), iters=3)
    got = bb.time_core_backward(qkv, dO, lse, delta, T, H).float()
    want = bb.time_core_backward_plain(qkv, dO, lse, delta, T, H)
    diff = (got - want).abs()
    if (diff > 2.0 ** -8 * want.abs() + 1e-4 * want.abs().max()).any():
        raise AssertionError(f"the backward time core disagrees with plain: {diff.max().item()}")
    bnd = bound_ms(*time_bwd_work(B, T, N, H, d))
    print(f"[6] time core backward alone B={B} S={1 + T * N} d={d}: {ms:.3f} ms, plain "
          f"{p_ms:.3f} ms, masked scaled_dot_product_attention backward {l_ms:.3f} ms, "
          f"bound {bnd[0]:.3f} ms ({bnd[1]}), {ms / bnd[0]:.2f}x the bound, "
          f"max|diff| to plain {diff.max().item():.3e} [{card}]")
    return dict(ms=ms, plain_ms=p_ms, bound=bnd, library_ms=l_ms, max_abs_err=diff.max().item())


def space_bwd_work(B: int, T: int, N: int, H: int, d: int) -> tuple[float, float]:
    """(flops, bytes) of the backward space core: per (clip, frame, head)
    L = N + 1 elements, 10 * d * L^2 flops (the logits and dP, dq, dk and dv);
    qkv and dO read once with the lse and delta, dqkv written once."""
    S, D, L = 1 + T * N, H * d, N + 1
    return 10 * d * L * L * B * T * H, 2 * B * S * (3 * D + D + 3 * D) + 8 * B * H * S


# the space core's backward at the train shapes: (B, T, N, H, d)
SPACE_BWD_SHAPES = {"B/16 train": (20, 12, 98, 12, 64), "H/14 train": (8, 12, 76, 16, 80)}


def space_core_bwd_inputs(B, T, N, H, d, seed, dev, bb):
    """Seeded qkv and dO (bf16) and the lse and delta of the plain space core."""
    rng = np.random.default_rng(seed)
    S, D = 1 + T * N, H * d
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * D)), dtype=torch.bfloat16, device=dev)
    dO = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.bfloat16, device=dev)
    out, lse = bb.bk.space_core_plain(qkv, T, H)
    delta = (dO.float() * out).reshape(B, S, H, d).sum(-1).transpose(1, 2).contiguous()
    return qkv, dO, lse.contiguous(), delta


def space_core_bwd_pair(bb, qkv, dO, lse, delta, T: int, H: int) -> tuple:
    """The flash pair (flash_bwd_dq_kernel, flash_bwd_dkv_kernel with SPACE)
    and the CLS combine on the same inputs: the space core's first backward,
    which the port keeps for groups larger than one block. -> (dqkv, the
    frames' CLS partials)."""
    bk = bb.bk
    B, S, D3 = qkv.shape
    N, d = (S - 1) // T, D3 // 3 // H
    lib = bk.library()
    dqkv = torch.empty_like(qkv)
    partial = torch.empty(B, T, H, 3, d, dtype=torch.float32, device=qkv.device)
    stream = bk._stream(qkv)
    with torch.cuda.device(qkv.device):
        bk._check(lib, lib.tvts_flash_bwd(bk._ptr(qkv), bk._ptr(dO), bk._ptr(lse),
                                          bk._ptr(delta), bk._ptr(dqkv), bk._ptr(partial), B, T,
                                          N, S, H, d, d ** -0.5, stream))
        bk._check(lib, lib.tvts_cls_grad_combine(bk._ptr(partial), T, B, H, d, S, bk._ptr(dqkv),
                                                 stream))
    return dqkv, partial


def space_core_bwd_digests(dev, bb) -> None:
    """The backward space core at the B/16 (N = 98, d = 64) and H/14 (N = 76,
    d = 80) train shapes (B = 2, 1): the sha256 of its dqkv and of the frames'
    CLS partials (equal digests in two trees: bit-identical outputs); fails
    unless both are bit for bit the flash pair's on the same inputs."""
    import hashlib

    for label, (B, T, N, H, d) in zip(SPACE_BWD_SHAPES, ((2, 12, 98, 12, 64),
                                                         (1, 12, 76, 16, 80))):
        inputs = space_core_bwd_inputs(B, T, N, H, d, 55, dev, bb)
        with torch.cuda.device(dev):
            dqkv, partial = bb._space_core_backward(bb.bk.library(), *inputs, T, H)
        pair = space_core_bwd_pair(bb, *inputs, T, H)
        torch.cuda.synchronize()
        for name, t in (("dqkv", dqkv.view(torch.int16)), ("CLS partials", partial)):
            digest = hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()
            print(f"[6] space core backward {label} N={N} d={d}: {name} sha256 {digest}")
        if not (torch.equal(dqkv, pair[0]) and torch.equal(partial, pair[1])):
            raise AssertionError(f"the backward space core {label}: dqkv or the CLS partials "
                                 f"differ from the flash pair's")
        print(f"[6] space core backward {label}: bit for bit the flash pair's")


def space_bwd_check(got: torch.Tensor, want: torch.Tensor, T: int, H: int) -> float:
    """Holds the backward space core's dqkv [B, S, 3D] against the plain
    backward (f32): each element within 2^-8 * |ref| + 2^-7 * the largest
    |ref| of its group. A patch row's group is its (frame, q/k/v, head) over
    the frame's N patches; the CLS row's is its (q/k/v, head), so the CLS
    row is held to its own scale, not to the patch rows'. The kernel rounds P
    and dS to bf16 for its tensor-core products, as the flash pair before it
    and the TPU kernel's bf16 products do, so an element keeps the rounding
    of its group's largest terms (2^-9 of each): a bf16-rounding model of the
    kernel, stored in bf16, reaches half of this band at the train groups,
    and the CLS query's logit on the CLS key counted in every frame exceeds
    it 14 to 66 times over (tests/test_torch_space_ln_backward.py). Returns
    max|diff|."""
    B, S, D3 = want.shape
    N, d = (S - 1) // T, D3 // 3 // H
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    patch = ref[:, 1:].reshape(B, T, N, 3, H, d).amax(dim=(2, 5), keepdim=True)
    cls = ref[:, :1].reshape(B, 1, 3, H, d).amax(dim=-1, keepdim=True)
    group = torch.cat([cls.expand(B, 1, 3, H, d).reshape(B, 1, D3),
                       patch.expand(B, T, N, 3, H, d).reshape(B, T * N, D3)], dim=1)
    bound = 2.0 ** -8 * ref + 2.0 ** -7 * group
    if not torch.isfinite(got.float()).all() or (diff > bound).any():
        raise AssertionError(f"the backward space core disagrees with plain: max|diff| "
                             f"{diff.max().item()}, {(diff > bound).sum().item()} elements over")
    return diff.max().item()


def core_backward_library_call(qkv, dO, T: int, H: int, mode: str):
    """A divided core's backward as one library call: the backward of a
    masked scaled_dot_product_attention (divided_mask) over the same q, k, v
    and dO, its forward run once beforehand. Timed as `library_ms`; the port
    never calls it."""
    from tvts_torch.ops.attention import split_heads

    B, S, D3 = qkv.shape
    d = D3 // 3 // H
    q, k, v = (split_heads(t, H).contiguous().requires_grad_() for t in qkv.chunk(3, dim=-1))
    mask = divided_mask(T, (S - 1) // T, mode, qkv.device)
    with torch.enable_grad():
        out = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                               scale=d ** -0.5)
    g = split_heads(dO, H).contiguous()
    return lambda: torch.autograd.grad(out, (q, k, v), g, retain_graph=True)


def space_core_bwd_times(dev, card: str, bb) -> dict:
    """The backward space core alone at the B/16 (B=20) and H/14 (B=8) train
    shapes, the CLS combine included (device time, device_ms), against its
    byte bound, the plain backward, the flash pair on the same inputs and one
    masked scaled_dot_product_attention backward (library_ms); held against
    the plain backward (space_bwd_check). Returns label -> the kernel line's
    numbers."""
    out = {}
    for label, (B, T, N, H, d) in SPACE_BWD_SHAPES.items():
        qkv, dO, lse, delta = space_core_bwd_inputs(B, T, N, H, d, 56, dev, bb)
        ms = device_ms(lambda: bb.space_core_backward(qkv, dO, lse, delta, T, H))
        pair_ms = device_ms(lambda: space_core_bwd_pair(bb, qkv, dO, lse, delta, T, H))
        p_ms = device_ms(lambda: bb.space_core_backward_plain(qkv, dO, lse, delta, T, H),
                         iters=3)
        l_ms = device_ms(core_backward_library_call(qkv, dO, T, H, "space"), iters=3)
        diff = space_bwd_check(bb.space_core_backward(qkv, dO, lse, delta, T, H),
                               bb.space_core_backward_plain(qkv, dO, lse, delta, T, H), T, H)
        bnd = bound_ms(*space_bwd_work(B, T, N, H, d))
        print(f"[6] space core backward alone {label} B={B} S={1 + T * N} d={d}: {ms:.3f} ms "
              f"(flash pair {pair_ms:.3f} ms), plain {p_ms:.3f} ms, masked "
              f"scaled_dot_product_attention backward {l_ms:.3f} ms, bound {bnd[0]:.3f} ms "
              f"({bnd[1]}), {ms / bnd[0]:.2f}x the bound, max|diff| to plain "
              f"{diff:.3e} [{card}]")
        out[label] = dict(ms=ms, plain_ms=p_ms, bound=bnd, library_ms=l_ms, max_abs_err=diff)
        del qkv, dO, lse, delta
    return out


def ln_bwd_work(M: int, K: int, res: bool, weight_grads: bool = True) -> tuple[float, float]:
    """(flops, bytes) of the LayerNorm backward over M rows of width K: x
    (bf16), dxln (f32), the row stats and res (bf16) read once, dx (bf16) and
    dln_w, dln_b (f32) written once; ~12 flops an element."""
    return 12 * M * K, M * K * (2 + 4 + 2 * res + 2) + 8 * M + 4 * K + 8 * K * weight_grads


# the LayerNorm backward at the train shapes: (M, K), with the residual
LN_BWD_SHAPES = {"B/16 train": (20 * (1 + 12 * 98), 768), "H/14 train": (8 * (1 + 12 * 76), 1280)}


def ln_bwd_inputs(M: int, K: int, seed: int, dev) -> tuple:
    """Seeded x, res (bf16), dxln (f32), ln_w (f32) and x's row stats."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal((M, K)) + 0.3, dtype=torch.bfloat16, device=dev)
    xf = x.float()
    stats = torch.stack([xf.mean(-1), torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5)], -1)
    dxln = torch.tensor(rng.standard_normal((M, K)), dtype=torch.float32, device=dev)
    ln_w = torch.tensor(1 + 0.1 * rng.standard_normal(K), dtype=torch.float32, device=dev)
    res = torch.tensor(rng.standard_normal((M, K)), dtype=torch.bfloat16, device=dev)
    return x, stats.contiguous(), dxln, ln_w, res


def ln_bwd_check(bb, got: tuple, args: tuple) -> float:
    """Holds the LayerNorm backward (dx, dln_w, dln_b) against plain in f64:
    dx within one bf16 unit of it plus 1e-5 * max|ref| (the f32 row sums),
    dln_w and dln_b within 1e-4 * max|ref|. Returns the largest |diff|."""
    x, stats, dxln, ln_w, res = args
    dx, dw, db = bb.ln_backward_plain(x.double(), stats.double(), dxln.double(), ln_w.double(),
                          None if res is None else res.double())
    diff = (got[0].double() - dx).abs()
    unit = torch.exp2(torch.floor(torch.log2(dx.abs().clamp_min(1e-30))) - 7)
    if (diff > unit + 1e-5 * dx.abs().max()).any():
        raise AssertionError(f"LayerNorm backward dx off plain by more than one bf16 unit: "
                             f"{diff.max().item()}")
    worst = diff.max().item()
    for name, g, w in (("dln_w", got[1], dw), ("dln_b", got[2], db)):
        if g is None:
            continue
        err = (g.double() - w).abs().max().item()
        if err > 1e-4 * w.abs().max().item():
            raise AssertionError(f"LayerNorm backward {name} off an f64 sum: {err}")
        worst = max(worst, err)
    return worst


def ln_bwd_times(dev, card: str, bb) -> dict:
    """The LayerNorm backward alone (row pass and column sums, with the
    residual) at the B/16 (M = 23,540, K = 768) and H/14 (M = 7,304, K = 1280)
    train shapes: device time (device_ms), split by kernel at B/16, and the
    frozen form (dx only), against its byte bound, the plain version and one
    torch.ops.aten.native_layer_norm_backward on the same shapes (x and dxln in
    f32, all three outputs: library_ms); held against plain (ln_bwd_check).
    Returns label -> the kernel line's numbers."""
    out = {}
    for label, (M, K) in LN_BWD_SHAPES.items():
        args = ln_bwd_inputs(M, K, 57, dev)
        x, stats, dxln, ln_w, res = args
        ms = device_ms(lambda: bb.ln_backward(x, stats, dxln, ln_w, res))
        frozen_ms = device_ms(lambda: bb.ln_backward(x, stats, dxln, ln_w, res,
                                                     weight_grads=False))
        p_ms = device_ms(lambda: bb.ln_backward_plain(x, stats, dxln, ln_w, res), iters=3)
        xf, bias = x.float(), torch.zeros_like(ln_w)
        mean, rstd = stats[:, :1].contiguous(), stats[:, 1:].contiguous()
        l_ms = device_ms(lambda: torch.ops.aten.native_layer_norm_backward(
            dxln, xf, [K], mean, rstd, ln_w, bias, [True, True, True]))
        err = ln_bwd_check(bb, bb.ln_backward(x, stats, dxln, ln_w, res), args)
        ln_bwd_check(bb, bb.ln_backward(x, stats, dxln, ln_w, None, weight_grads=False),
                     (x, stats, dxln, ln_w, None))
        bnd = bound_ms(*ln_bwd_work(M, K, True))
        print(f"[6] LayerNorm backward alone {label} M={M} K={K} (with res): {ms:.4f} ms, "
              f"frozen (dx only) {frozen_ms:.4f} ms, plain {p_ms:.3f} ms, "
              f"native_layer_norm_backward {l_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}), "
              f"{ms / bnd[0]:.2f}x the bound, max|diff| to plain {err:.3e} [{card}]")
        if label.startswith("B/16"):
            kernel_split("6", f"LayerNorm backward {label}",
                         lambda: bb.ln_backward(x, stats, dxln, ln_w, res), card)
        out[label] = dict(ms=ms, plain_ms=p_ms, bound=bnd, library_ms=l_ms, max_abs_err=err)
        del args, x, stats, dxln, ln_w, res, xf
    return out


def ln_bwd_digests(dev, bb) -> None:
    """The sha256 of the LayerNorm backward's dx at the B/16 and H/14 train
    shapes, with the residual and frozen (equal digests in two trees:
    bit-identical rows)."""
    import hashlib

    for label, (M, K) in LN_BWD_SHAPES.items():
        x, stats, dxln, ln_w, res = ln_bwd_inputs(M, K, 58, dev)
        for form, r, wg in (("with res", res, True), ("frozen", None, False)):
            dx = bb.ln_backward(x, stats, dxln, ln_w, r, weight_grads=wg)[0]
            torch.cuda.synchronize()
            digest = hashlib.sha256(dx.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            print(f"[6] LayerNorm backward {label} M={M} K={K} {form}: dx sha256 {digest}")


# the H7 cores alone at the train steps' shapes: (B, S, H, causal), head dim 64
TEXT_CORE_SHAPES = {"B/16 sort": (20, 1181, 8, False), "B/16 text": (80, 77, 8, True),
                    "H/14 sort": (8, 917, 16, False), "H/14 text": (32, 77, 16, True)}
# the forward-only core (head dim 88) at VideoMAE V2 ViT-g/14's joint attention
# in the g14.classify cell: (B, S, H, d, causal)
TEXT_CORE_FWD_SHAPES = {"ViT-g joint": (15, 2048, 16, 88, False)}
TEXT_LSE_TOL = 1e-3  # the H7 core's lse against plain (f32 sums in another order)


def text_core_inputs(B: int, S: int, H: int, seed: int, dev, d: int = 64) -> tuple:
    """Seeded qkv [B, S, 3 * H * d] and dO [B, S, H * d] (bf16): logits of
    unit variance at d = 64."""
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * H * d)), dtype=torch.bfloat16,
                       device=dev)
    dO = torch.tensor(rng.standard_normal((B, S, H * d)), dtype=torch.bfloat16, device=dev)
    return qkv, dO


def text_core_work(B: int, S: int, H: int, causal: bool, backward: bool, d: int = 64) -> tuple:
    """(flops, bytes) of the H7 core: 4 d (forward: logits, P V) or 10 d
    (backward: logits, dP, dq, dk, dv) flops a (query, key) pair of every
    head, at the head dim d (the zero columns d = 88 is padded with are not
    work); forward qkv read and out and lse written, backward qkv, out, lse
    and dO read and dqkv written, each once. The backward kernels recompute
    the logits and dP in both passes: 14 d a pair."""
    D = H * d
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    if backward:
        return 10 * d * pairs, 2 * B * S * (3 * D + D + D + 3 * D) + 4 * B * H * S
    return 4 * d * pairs, 2 * B * S * (3 * D + D) + 4 * B * H * S


def text_core_check(tag: str, ta, qkv, dO, H: int, causal: bool) -> tuple:
    """Holds the H7 cores against their plain versions on the same inputs: out
    within BAND * max(1, mean|ref| / 0.8) (band_check), lse within
    TEXT_LSE_TOL, each of dq, dk and dv within GRAD_BAND * max|ref| of the
    plain backward from the kernel's own out and lse (what the training
    backward gets); two runs of each kernel bit-equal. dO None: the forward
    alone (the d = 88 core has no backward). -> (out, lse, dqkv, max|diff| of
    out, the largest max|diff| of dq, dk, dv; the last two None without
    dO)."""
    out, lse = ta.text_core(qkv, H, causal, with_lse=True)
    again = ta.text_core(qkv, H, causal, with_lse=True)
    if dO is None:
        dqkv = dqkv2 = None
    else:
        dqkv = ta.text_core_backward(qkv, out, lse, dO, H, causal)
        dqkv2 = ta.text_core_backward(qkv, out, lse, dO, H, causal)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])
            and (dO is None or torch.equal(dqkv, dqkv2))):
        raise AssertionError(f"H7 cores {tag}: two runs are not bit-equal")
    ref, ref_lse = ta.text_core_plain(qkv, H, causal)
    diff, mean, tol = band_check(out, ref)
    if not torch.isfinite(lse).all():
        raise AssertionError(f"H7 core {tag}: non-finite lse")
    lse_err = (lse - ref_lse).abs().max().item()
    print(f"[6] text_core {tag}: out max|diff| {diff:.5f} mean|ref| {mean:.4f} (tol {tol:.4f}), "
          f"lse max|diff| {lse_err:.3e} (<= {TEXT_LSE_TOL}); two runs bit-equal")
    if diff > tol or lse_err > TEXT_LSE_TOL:
        raise AssertionError(f"H7 core {tag}: out {diff} > {tol} or lse {lse_err}")
    del ref, ref_lse
    if dO is None:
        return out, lse, None, diff, None
    want = ta.text_core_backward_plain(qkv, out, lse, dO, H, causal)
    D = H * 64
    worst = grad_band_check(f"text_core_backward {tag}", ("dq", "dk", "dv"),
                            dqkv.split(D, dim=-1), want.split(D, dim=-1))
    return out, lse, dqkv, diff, worst


def text_core_times(dev, card: str, ta) -> dict:
    """The H7 cores alone at the B/16 and H/14 train shapes (sort head, text
    tower: TEXT_CORE_SHAPES), forward (with the lse, as training runs it) and
    backward, and the forward alone at head dim 88 (TEXT_CORE_FWD_SHAPES),
    held to text_core_check, with the sha256 of out, lse and dqkv (equal
    digests in two trees: bit-identical outputs); device time (device_ms)
    against their bound, the plain versions and one
    scaled_dot_product_attention forward / backward over the same q, k, v
    (causal for the text: `library_ms`). Returns label -> {"text_core":
    numbers, "text_core_backward": numbers (not at d = 88)} for the kernel
    line."""
    import hashlib

    sdpa = torch.nn.functional.scaled_dot_product_attention
    shapes = [(label, (B, S, H, 64, causal)) for label, (B, S, H, causal)
              in TEXT_CORE_SHAPES.items()] + list(TEXT_CORE_FWD_SHAPES.items())
    out_lines = {}
    for label, (B, S, H, d, causal) in shapes:
        backward = d == 64
        qkv, dO = text_core_inputs(B, S, H, 61, dev, d)
        out, lse, dqkv, f_err, b_err = text_core_check(label, ta, qkv, dO if backward else None,
                                                       H, causal)
        for name, t in (("out", out.view(torch.int16)), ("lse", lse),
                        ("dqkv", None if dqkv is None else dqkv.view(torch.int16))):
            if t is None:
                continue
            digest = hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()
            print(f"[6] text core {label} B={B} S={S} H={H}: {name} sha256 {digest}")
        f_ms = device_ms(lambda: ta.text_core(qkv, H, causal, with_lse=True))
        fp_ms = device_ms(lambda: ta.text_core_plain(qkv, H, causal), iters=3)
        q, k, v = (t.reshape(B, S, H, d).transpose(1, 2).contiguous().requires_grad_()
                   for t in qkv.chunk(3, dim=-1))
        with torch.no_grad():
            lf_ms = device_ms(lambda: sdpa(q, k, v, is_causal=causal))
        rows = [("text_core", f_ms, fp_ms, lf_ms, f_err, False)]
        o = go = None
        if backward:
            b_ms = device_ms(lambda: ta.text_core_backward(qkv, out, lse, dO, H, causal))
            bp_ms = device_ms(lambda: ta.text_core_backward_plain(qkv, out, lse, dO, H, causal),
                              iters=3)
            with torch.enable_grad():
                o = sdpa(q, k, v, is_causal=causal)
            go = dO.reshape(B, S, H, 64).transpose(1, 2).contiguous()
            lb_ms = device_ms(lambda: torch.autograd.grad(o, (q, k, v), go, retain_graph=True))
            rows.append(("text_core_backward", b_ms, bp_ms, lb_ms, b_err, True))
        lines = {}
        for name, ms, p_ms, l_ms, err, bwd in rows:
            bnd = bound_ms(*text_core_work(B, S, H, causal, bwd, d))
            extra = "; the kernels do 14 d flops a pair" if bwd else ""
            print(f"[6] {name} alone {label} B={B} S={S} H={H} d={d}"
                  f"{' causal' if causal else ''}: "
                  f"{ms:.4f} ms, plain {p_ms:.3f} ms, scaled_dot_product_attention "
                  f"{'backward ' if bwd else ''}{l_ms:.4f} ms, bound {bnd[0]:.4f} ms "
                  f"({bnd[1]}{extra}), {ms / bnd[0]:.2f}x the bound, {ms / l_ms:.2f}x the "
                  f"library call [{card}]")
            lines[name] = dict(ms=ms, plain_ms=p_ms, bound=bnd, library_ms=l_ms, max_abs_err=err)
        out_lines[label] = lines
        del qkv, dO, out, lse, dqkv, q, k, v, o, go
        torch.cuda.empty_cache()
    return out_lines


def forward_profile(cfg, model, B: int, dev, card: str, bk) -> dict:
    """Device time by CUDA kernel of one kernel-path extraction forward at B
    clips, and of H1, H2, H3 and H4 alone on [B, S, D] inputs. Returns each
    sub-path's CUDA kernel names."""
    from tvts_torch.eval.embed import make_embed_fns

    v = cfg.vision
    gen = torch.Generator(device=dev).manual_seed(3)
    video = torch.randn(B, v.num_frames, 3, v.input_resolution, v.input_resolution,
                        generator=gen, device=dev)
    keep = torch.arange(v.patches_per_frame, device=dev)[None].expand(B, -1)
    _, embed_video = make_embed_fns(model, use_fused=True)
    profile_kernels("6", f"{cfg.name} extraction forward B={B}", lambda: embed_video(video, keep),
                    card, top=16)
    del video
    a = seeded_inputs(1, 1, 1, v.width, seed=0, device=dev)
    S = 1 + v.num_frames * v.patches_per_frame
    a["x"] = torch.randn(B, S, v.width, generator=gen, device=dev, dtype=torch.bfloat16)
    a["base"] = a["x"]
    calls = kernel_calls(bk, a, v.num_frames, v.heads, v.act)
    names = {}
    with torch.inference_mode():
        for name in ("fused_time_block", "fused_space_block", "fused_mlp_block",
                     "fused_space_cls_only"):
            rows = profile_kernels("6", f"{name} B={B}", calls[name][0], card)
            names[name] = None if rows is None else [key for _, key, _ in rows]
    return names


def expect_profiles(names: dict) -> None:
    """H2 runs no split-KV CLS row (its CLS query is folded into the space
    core), and H4 runs no ln_gemm: no product over all B*S rows. Not checked
    where the profiler gave up on either."""
    if names["fused_space_block"] is None or names["fused_space_cls_only"] is None:
        UNPROFILED.append("[6] H2 launches no cls_partial, H4 no ln_gemm (the check)")
        return
    if any("cls_partial" in key for key in names["fused_space_block"]):
        raise AssertionError(f"H2 still launches cls_partial: {names['fused_space_block']}")
    if any("gemm" in key for key in names["fused_space_cls_only"]):
        raise AssertionError(f"H4 launches a product kernel: {names['fused_space_cls_only']}")
    print(f"[6] H2 alone launches no cls_partial; H4 alone no ln_gemm: "
          f"{sorted(set(k[:60] for k in names['fused_space_cls_only']))}")


def cls_row_check(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """The CLS row (f32 P V, one bf16 store) against plain in f32: every
    element within half a bf16 unit of the plain value (2^-8 |want|) plus
    1e-5 * max|want|. -> (max|diff|, the share of elements whose bf16 value
    is not plain's rounded to bf16)."""
    want = want.float()
    diff = (got.float() - want).abs()
    bound = 2.0 ** -8 * want.abs() + 1e-5 * want.abs().max()
    if (diff > bound).any():
        raise AssertionError(f"the CLS row is off by more than its bf16 store: max|diff| "
                             f"{diff.max().item():.3e}, {(diff > bound).sum().item()} elements")
    share = (got != want.to(got.dtype)).float().mean().item()
    return diff.max().item(), share


def space_core_rows(dev, bk) -> None:
    """The space core on seeded inputs (B/16's N = 196, d = 64; H/14's N =
    256, d = 80): the sha256 of its patch rows and their lse (equal digests
    in two trees mean bit-identical patch rows), and its CLS row against
    plain (cls_row_check)."""
    import hashlib

    for B, T, N, H, d in ((2, 12, 196, 12, 64), (1, 12, 256, 16, 80)):
        rng = np.random.default_rng(51)
        qkv = torch.tensor(rng.standard_normal((B, 1 + T * N, 3 * H * d)), dtype=torch.bfloat16,
                           device=dev)
        out, lse = bk.space_core(qkv, T, H, with_lse=True)
        torch.cuda.synchronize()
        digest = hashlib.sha256(out[:, 1:].contiguous().view(torch.int16).cpu().numpy().tobytes()
                                + lse[:, :, 1:].contiguous().cpu().numpy().tobytes())
        print(f"[6] space core N={N} d={d}: patch rows and lse sha256 {digest.hexdigest()}")
        want, want_lse = bk.space_core_plain(qkv, T, H)
        diff, share = cls_row_check(out[:, 0], want[:, 0])
        lse_diff = (lse[:, :, 0] - want_lse[:, :, 0]).abs().max().item()
        print(f"[6] space core N={N} d={d}: CLS row max|diff| to plain (f32) {diff:.3e} "
              f"(max|ref| {want[:, 0].abs().max().item():.4f}), {share:.4%} of its elements "
              f"not plain's rounded to bf16; its lse max|diff| {lse_diff:.3e}")


def space_core_times(dev, card: str, bk, cfg, B: int) -> tuple:
    """The space core alone at the extraction shape (CLS row included): ms,
    its byte bound (q, k, v read once, the output written once) and one masked
    scaled_dot_product_attention over the same q, k and v (library_ms, timed
    here only), which it must match. Returns (ms, bound, library ms)."""
    from tvts_torch.ops.attention import merge_heads, split_heads

    v = cfg.vision
    T, N, H, D = v.num_frames, v.patches_per_frame, v.heads, v.width
    S = 1 + T * N
    gen = torch.Generator(device=dev).manual_seed(52)
    qkv = torch.randn(B, S, 3 * D, generator=gen, device=dev, dtype=torch.bfloat16)
    d = D // H

    def call():
        return bk.space_core(qkv, T, H)
    q, k, vv = qkv.chunk(3, dim=-1)
    views = (split_heads(q * d ** -0.5, H), split_heads(k, H), split_heads(vv, H))
    one_call = core_library_call(views, T, N, "space")
    with torch.inference_mode():
        ms = cuda_ms(call, iters=10)
        l_ms = cuda_ms(one_call, iters=5)
        out = call()
        diff, ref, tol = core_band_check(out, merge_heads(one_call()))
    if diff > tol:
        raise AssertionError(f"the space core disagrees with the masked library call: {diff}")
    bnd = bound_ms(*core_work("space", B, T, N, H, d))
    print(f"[6] space core alone B={B} S={S} (CLS row included): {ms:.3f} ms, masked "
          f"scaled_dot_product_attention {l_ms:.3f} ms (max|diff| {diff:.5f}, tol {tol:.5f}), "
          f"bound {bnd[0]:.3f} ms ({bnd[1]}), {ms / bnd[0]:.2f}x the bound [{card}]")
    del qkv, out
    return ms, bnd, l_ms


def block_times(bk, v, B: int, dev, card: str) -> dict:
    """H1-H4 at [B, 1 + T*N, D] against their plain versions: name -> (ms,
    plain ms, bound). H4's bound is its function's least work: x read once,
    the weights once, the absorbed products (logits and P^T Y over every row,
    4 * B*S*D*H flops, and the CLS rows' matvecs)."""
    gen = torch.Generator(device=dev).manual_seed(3)
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
            M, D = B * S, v.width
            if name == "fused_mlp_block":
                work = mlp_work(M, D, False, False)
            elif name == "fused_space_cls_only":
                work = (4 * M * D * v.heads + 8 * B * D * D, 2 * M * D + 8 * D * D + 4 * B * D)
            else:
                work = attention_work("time" if name == "fused_time_block" else "space", B,
                                      v.num_frames, v.patches_per_frame, v.width, v.heads,
                                      backward=False)
            times[name] = (k_ms, p_ms, bound_ms(*work))
            print(f"[6] {name:22s} B={B}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound "
                  f"{times[name][2][0]:.3f} ms ({times[name][2][1]}) [{card}]")
    return times


def no_tf32():
    """Context: full-float32 products and convolutions for the f32 reference."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

    return ctx()


def extraction_phase(tag: str, arch: str, dev, bk, bb, ta, n_clips: int, batch_size: int,
                     noise_seed: int) -> dict:
    """build_model(arch) in bf16 and f32 with seeded weights and noise on every
    leaf; extract_embeddings over ceil(n_clips / batch_size) batches (the last
    ragged) through the kernels, with the launch counts layers / layers-1 /
    layers-1 / 1 per forward; pooled cosine against the eager tower in bf16
    and f32."""
    from tvts_torch.eval.embed import extract_embeddings
    from tvts_torch.models.factory import build_model

    cfg, model = build_model(arch, dtype=torch.bfloat16, device=dev, seed=0)
    _, model32 = build_model(arch, dtype=torch.float32, device=dev, seed=0)
    add_noise_(model32, noise_seed, dev)
    model.load_state_dict(model32.state_dict())
    zero = [n for n, p in model.named_parameters() if not p.any()]
    if zero:
        raise AssertionError(f"all-zero parameters: {zero}")
    v, tc = cfg.vision, cfg.text
    print(f"[{tag}] {cfg.name}: video width {v.width}, {v.layers} blocks, {v.heads} heads, "
          f"{v.num_frames} frames, {v.patches_per_frame} patches/frame, {v.act}, "
          f"{v.pool_style} pool; text width {tc.width}, {tc.layers} blocks, {tc.heads} heads, "
          f"context {tc.context_length}; {sum(p.numel() for p in model.parameters())} "
          f"parameters, all non-zero")
    clips = np.random.default_rng(2).standard_normal(
        (n_clips, v.num_frames, 3, v.input_resolution, v.input_resolution)).astype(np.float32)
    loader = SyntheticLoader(clips, v.patches_per_frame, batch_size=batch_size)
    n_forwards = -(-n_clips // batch_size)
    reset_launch_counts(bk, bb, ta)
    fused = extract_embeddings(model, loader, use_fused=True)["video"]
    launches = launch_counts(bk, bb, ta)
    per_forward = dict(zip([fn.__name__ for fn in bk.KERNELS],
                           (v.layers, v.layers - 1, v.layers - 1, 1)))
    print(f"[{tag}] launches over {n_forwards} forwards: "
          f"{ {k: n for k, n in launches.items() if n} }, LayerNorm row passes "
          f"{bk.ln_rows.launches}")
    expect_launches(f"{cfg.name} extraction", launches,
                    {name: n * n_forwards for name, n in per_forward.items()})
    # one row pass a LayerNorm product: H1, H2 and H3 each have one, H4 none
    rows = 3 * v.layers - 2
    if bk.ln_rows.launches != rows * n_forwards:
        raise AssertionError(f"{cfg.name} extraction: {bk.ln_rows.launches} LayerNorm row "
                             f"passes, expected {rows} a forward")
    eager = extract_embeddings(model, loader, use_fused=False)["video"]
    with no_tf32():
        eager32 = extract_embeddings(model32, loader, use_fused=False)["video"]
    if fused.shape != (n_clips, v.output_dim) or not np.isfinite(fused).all():
        raise AssertionError(f"fused embeddings: shape {fused.shape} or non-finite")
    c16, c32 = cos_rows(fused, eager).min(), cos_rows(fused, eager32).min()
    unit = fused / np.linalg.norm(fused, axis=-1, keepdims=True)
    across = (unit @ unit.T)[~np.eye(len(unit), dtype=bool)].mean()
    print(f"[{tag}] pooled cosine, kernel path vs eager: min {c16:.6f} (bf16, >= {COS_BF16}), "
          f"min {c32:.6f} (f32, >= {COS_F32}); mean cosine across clips {across:.4f}")
    if c16 < COS_BF16 or c32 < COS_F32:
        raise AssertionError(f"{cfg.name}: kernel path disagrees with the eager tower")
    return dict(cfg=cfg, model=model, model32=model32, clips=clips, fused=fused, eager=eager,
                eager32=eager32, launches=launches, per_forward=per_forward,
                n_forwards=n_forwards)


def extraction_rate(tag: str, cfg, model, B: int, dev, card: str, iters: int) -> dict:
    """clips/s of embed_video on B device-resident clips, kernels and eager."""
    from tvts_torch.eval.embed import make_embed_fns

    v = cfg.vision
    gen = torch.Generator(device=dev).manual_seed(3)
    video = torch.randn(B, v.num_frames, 3, v.input_resolution, v.input_resolution,
                        generator=gen, device=dev)
    keep = torch.arange(v.patches_per_frame, device=dev)[None].expand(B, -1)
    rates = {}
    for path, use_fused in (("kernels", True), ("eager", False)):
        _, embed_video = make_embed_fns(model, use_fused=use_fused)
        ms = cuda_ms(lambda: embed_video(video, keep), iters=iters)
        rates[path] = B / (ms / 1e3)
        print(f"[{tag}] {cfg.name} extraction B={B} {path:7s}: {ms:.2f} ms/batch, "
              f"{rates[path]:.2f} clips/s [{card}]")
    print(f"[{tag}] {cfg.name} extraction kernels / eager: "
          f"{rates['kernels'] / rates['eager']:.3f} [{card}]")
    return rates


def use_pallas_phase(tag: str, ext: dict, dev, bk, bb, ta) -> dict:
    """Extraction through the eager tower built with use_pallas=True (the
    space core of every block on H9) against the same tower without it, in
    bf16 and in f32 (H9's f32 kernels; the f32 towers with full-f32
    products); then H9 in time mode on f32 q, k, v, called directly. Returns
    the H9 launches: bf16, f32 and f32 time."""
    from tvts_torch.eval.embed import extract_embeddings
    from tvts_torch.models.factory import build_model
    from tvts_torch.ops import attention_cores as ac
    from tvts_torch.ops.attention import divided_space_time_attention

    cfg, name = ext["cfg"], "divided_space_time_attention_fused"
    want = cfg.vision.layers * ext["n_forwards"]
    loader = SyntheticLoader(ext["clips"], cfg.vision.patches_per_frame, batch_size=8)
    out = {}
    for dtype, ref, cos_min in ((torch.bfloat16, "eager", COS_BF16),
                                (torch.float32, "eager32", COS_F32)):
        label = "bf16" if dtype == torch.bfloat16 else "f32"
        _, model = build_model(cfg.name, dtype=dtype, device=dev, seed=0, use_pallas=True)
        model.load_state_dict(ext["model32"].state_dict())
        reset_launch_counts(bk, bb, ta)
        with no_tf32():
            got = extract_embeddings(model, loader, use_fused=False)["video"]
        launches = launch_counts(bk, bb, ta)
        print(f"[{tag}] use_pallas=True eager tower ({label}): launches over "
              f"{ext['n_forwards']} forwards: { {k: n for k, n in launches.items() if n} }")
        expect_launches(f"use_pallas extraction ({label})", launches,
                        {name: want, f"{name} (f32)": want * (label == "f32")})
        cos = cos_rows(got, ext[ref]).min()
        diff = float(np.abs(got - ext[ref]).max())
        print(f"[{tag}] pooled, use_pallas=True vs use_pallas=False ({label}): min cosine "
              f"{cos:.6f} (>= {cos_min}), max|diff| {diff:.3e}")
        ok = np.isfinite(got).all() and cos >= cos_min
        if label == "bf16":
            c32 = cos_rows(got, ext["eager32"]).min()
            print(f"[{tag}] use_pallas=True (bf16) vs the f32 tower: min cosine {c32:.6f} "
                  f"(>= {COS_F32})")
            ok = ok and c32 >= COS_F32
        else:
            tol = F32_TOWER_BAND * float(np.abs(ext[ref]).max())
            controls = f32_tower_controls(model, loader, ext[ref])
            print(f"[{tag}] use_pallas=True (f32): max|diff| {diff:.3e} <= {tol:.3e} "
                  f"({F32_TOWER_BAND} * max|ref|); the tower with H9 as a control that is not f32, "
                  "above it: " + ", ".join(f"{k} {c:.3e}" for k, c in controls.items()))
            if min(controls.values()) <= tol:
                raise AssertionError(f"a control that is not f32 passes the f32 tower's band "
                                     f"{tol}: {controls}")
            ok = ok and diff <= tol
        if not ok:
            raise AssertionError(f"the use_pallas tower ({label}) disagrees with the plain "
                                 "eager tower")
        out[name if label == "bf16" else f"{name} (f32)"] = launches[name]
        del model
    # H9 time on f32 q, k, v: no tower calls it (they run space), so the entry
    # is called as a user would, at the f32 tower's batch and shape
    v = cfg.vision
    T, N, H, d = v.num_frames, v.patches_per_frame, v.heads, v.width // v.heads
    qkv = core_inputs(8, T, N, H, d, 21, dev, dtype=torch.float32)
    reset_launch_counts(bk, bb, ta)
    with torch.no_grad(), no_tf32():
        got = ac.divided_space_time_attention_fused(*qkv, T, N, "time")
        launches = launch_counts(bk, bb, ta)
        want = divided_space_time_attention(*qkv, T, N, "time")
    expect_launches("H9 time (f32)", launches,
                    {name: 1, f"{name} (f32)": 1, f"{name} (f32 time)": 1})
    diff, ref, _ = core_band_check(got, want)
    print(f"[{tag}] divided_space_time_attention_fused(mode=\"time\") on f32 q, k, v B=8 N={N}: "
          f"launches { {k: n for k, n in launches.items() if n} }; max|diff| to plain f32 "
          f"{diff:.3e} <= {F32_BAND * ref:.3e} ({F32_BAND} * max|ref|)")
    if diff > F32_BAND * ref:
        raise AssertionError(f"H9 time (f32): max|diff| {diff} > {F32_BAND} * {ref}")
    out[f"{name} (f32 time)"] = launches[f"{name} (f32 time)"]
    del qkv, got, want
    torch.cuda.empty_cache()  # the later profiles need device memory for their records
    return out


def f32_tower_controls(model, loader, want: np.ndarray) -> dict:
    """max|diff| to `want` of the f32 use_pallas tower's pooled output with
    its H9 calls computed as each F32_CONTROLS kernel would."""
    from tvts_torch.eval.embed import extract_embeddings
    from tvts_torch.ops import attention_cores as ac
    from tvts_torch.ops.attention import divided_space_time_attention as plain

    kernel, out = ac.divided_space_time_attention_fused, {}
    try:
        for name, read in F32_CONTROLS.items():
            ac.divided_space_time_attention_fused = \
                lambda q, k, v, T, N, mode, read=read: plain(*read(q, k, v), T, N, mode)
            with no_tf32():
                got = extract_embeddings(model, loader, use_fused=False)["video"]
            out[name] = float(np.abs(got - want).max())
    finally:
        ac.divided_space_time_attention_fused = kernel
    return out


def b32_phase(dev, card, bk, bb, ta) -> None:
    """Phase 9: B/32 (N = 49) through the extraction kernels, and its rate."""
    ext = extraction_phase("9", "TVTSv2_B_32", dev, bk, bb, ta, n_clips=8, batch_size=8,
                           noise_seed=21)
    extraction_rate("6", ext["cfg"], ext["model"], 64, dev, card, iters=5)


def h14_phase(dev, card, bk, bb, ta) -> None:
    """Phase 8: H/14 at full width and depth through every path (module notes)."""
    from tvts_torch.eval.zero_ret import run_retrieval

    ext = extraction_phase("8", "TVTSv2_H_14", dev, bk, bb, ta, n_clips=7, batch_size=4,
                           noise_seed=22)
    cfg, model = ext["cfg"], ext["model"]
    del ext["model32"]
    torch.cuda.empty_cache()
    captions = synthetic_captions(len(ext["clips"]), seed=4)
    loader = SyntheticLoader(ext["clips"], cfg.vision.patches_per_frame, 4, text=captions)
    reset_launch_counts(bk, bb, ta)
    ret, sims = run_retrieval(model, loader, use_fused=True)
    launches = launch_counts(bk, bb, ta)
    n = ext["n_forwards"]
    print(f"[8] zero-shot launches over {n} text and {n} video forwards: "
          f"{ {k: c for k, c in launches.items() if c} }")
    want = {name: c * n for name, c in ext["per_forward"].items()}
    want["fused_text_attention_block"] = want["text_core"] = (cfg.text.layers - 1) * n
    expect_launches("H/14 zero-shot", launches, want)
    ret_eager, sims_eager = run_retrieval(model, loader, use_fused=False)
    for path, res in (("kernels", ret), ("eager", ret_eager)):
        print(f"[8] retrieval {path:7s}: " + json.dumps(res))
    print(f"[8] retrieval sims {sims.shape}, max|diff| kernels vs eager "
          f"{float(np.abs(sims - sims_eager).max()):.6f}")
    if sims.shape != (len(captions),) * 2 or not np.isfinite(sims).all():
        raise AssertionError("H/14 retrieval similarity matrix: wrong shape or non-finite")
    extraction_rate("6", cfg, model, 16, dev, card, iters=3)
    del ext, model
    torch.cuda.empty_cache()

    train = build_train("TVTSv2_H_14", dev, noise_seed=23, text_tune_layers=6, tag="8")
    cfg = train["cfg"]
    L, TL, frozen = cfg.vision.layers, cfg.text.layers, train["ocfg"].text_tune_from
    batch = train_batch(cfg, 4, seed=24, device=dev)
    preset = kernel_apply(train, "8")
    got = step0_gate("8", "preset", train["model"], batch, preset, bk, bb, ta)
    expect_launches("H/14 gate, preset", got,
                    step_launches(L, TL, frozen, time=False, sort=False))
    n_steps = 2
    launches = optimizer_steps("8", train, preset, batch, n_steps, bk, bb, ta)
    expect_launches("H/14 steps", launches,
                    step_launches(L, TL, frozen, n_steps, time=False, sort=False))
    every = kernel_apply(train, "8", time_mode="pallas", mlp_mode="pallas", sort_mode="pallas")
    got = step0_gate("8", "every kernel", train["model"], batch, every, bk, bb, ta)
    expect_launches("H/14 gate, every kernel", got, step_launches(L, TL, frozen, mlp=True))
    # ---- phases 15 and 16, H/14: the same gates on a sharded and a tp copy ----
    gates = ({"preset": preset, "every kernel": every},
             {"preset": step_launches(L, TL, frozen, time=False, sort=False),
              "every kernel": step_launches(L, TL, frozen, mlp=True)})
    fsdp_h14_gates(dev, train, batch, *gates, bk, bb, ta)
    tp_h14_gates(dev, train, batch, *gates, bk, bb, ta)

    B = 8
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[6] before the H/14 steps at B={B}: {(total - free) / 2 ** 30:.2f} GiB of "
          f"{total / 2 ** 30:.2f} GiB in use [{card}]")
    batch = train_batch(cfg, B, seed=25, device=dev)
    for label, apply_fn in (("preset", preset), ("every kernel", every), ("eager", None)):
        time_steps("6", label, train, apply_fn, batch, card, iters=2)
    profile_step("6", train, preset, batch, card)
    # H8 and H7 at this model's B=8 shapes
    v = cfg.vision
    S = 1 + v.num_frames * v.n_keep
    a = seeded_inputs(1, 1, 1, v.width, seed=26, device=dev)
    gen = torch.Generator(device=dev).manual_seed(27)
    a["x"] = torch.randn(B, S, v.width, generator=gen, device=dev, dtype=torch.bfloat16)
    g = torch.randn(B, S, v.width, generator=gen, device=dev, dtype=torch.bfloat16)
    mlp_times("6", card, bk, bb, a, g, v.act, None)


def parity_phase(dev, bk, bb, ta, ac) -> dict:
    """Phase 3 (module notes). Returns name -> max|diff| at the B/16 shapes."""
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
                  f"(tol {tol:.4f}) sha256 {sha256_of(got)}")
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
        print(f"[3] fused_text_attention_block {label:14s} B={B} S={S} D={D} H={H} "
              f"causal={causal} eps={eps:g}: max|diff| {diff:.5f} mean|ref| {ref:.4f} "
              f"(tol {tol:.4f})")
        if diff > tol:
            raise AssertionError(f"fused_text_attention_block {label}: max|diff| {diff} > {tol}")
        if label == "B/16 text":
            max_err["fused_text_attention_block"] = diff
    for label, (B, T, N, D, H) in BWD_SHAPES.items():
        a = seeded_inputs(B, T, N, D, seed=7, device=dev)
        g = seeded_inputs(B, T, N, D, seed=8, device=dev)["x"]
        w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
        with torch.no_grad():  # the saving forwards
            for name, got, want in (
                    ("time_subpath", bb.time_subpath(a["x"], *w, T, H),
                     bk.time_block_plain(a["x"], *w, T, H)),
                    ("space_subpath", bb.space_subpath(a["x"], a["base"], *w, T, H),
                     bk.space_block_plain(a["x"], a["base"], *w, T, H))):
                diff, ref, tol = band_check(got, want)
                print(f"[3] {name:22s} {label:12s} (saving forward) max|diff| {diff:.5f} "
                      f"mean|ref| {ref:.4f} (tol {tol:.4f})")
                if diff > tol:
                    raise AssertionError(f"{name} {label}: max|diff| {diff} > {tol}")
                if label == "B/16 train":
                    max_err[name] = diff
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
    for label, (B, T, N, D, act) in MLP_SHAPES.items():
        a = seeded_inputs(B, T, N, D, seed=7, device=dev)
        g = seeded_inputs(B, T, N, D, seed=8, device=dev)["x"]
        for save in (False, True):
            form = "saved hidden" if save else "recomputing"
            fwd, fwd_plain, bwd, bwd_plain = mlp_calls(bk, bb, a, g, act, save)
            (out, h), (want, want_h) = fwd(), fwd_plain()
            torch.cuda.synchronize()
            if (h is not None) != save:
                raise AssertionError(f"mlp_subpath {label}: hidden saved {h is not None}")
            for what, x, y in (("out", out, want),) + ((("hidden", h, want_h),) if save else ()):
                diff, ref, tol = band_check(x, y)
                print(f"[3] mlp_subpath {label} {act} ({form}) {what}: max|diff| {diff:.5f} "
                      f"mean|ref| {ref:.4f} (tol {tol:.4f})")
                if diff > tol:
                    raise AssertionError(f"mlp_subpath {label} {what}: max|diff| {diff} > {tol}")
                if label == "B/16 train" and what == "out":
                    max_err["mlp_subpath" + (" (saved hidden)" if save else "")] = diff
            before = (bb.mlp_subpath.launches, bb.mlp_subpath.saved_launches,
                      bb.mlp_subpath_backward.launches, bb.mlp_subpath_backward.saved_launches)
            got = bwd()
            torch.cuda.synchronize()
            after = (bb.mlp_subpath.launches, bb.mlp_subpath.saved_launches,
                     bb.mlp_subpath_backward.launches, bb.mlp_subpath_backward.saved_launches)
            if after != (before[0] + 1, before[1] + save, before[2] + 1, before[3] + save):
                raise AssertionError(f"mlp_subpath did not count its launches: {before} {after}")
            worst = grad_band_check(f"mlp_subpath_backward {label} ({form})", MLP_GRAD_NAMES,
                                    got, bwd_plain())
            if label == "B/16 train":
                max_err["mlp_subpath_backward" + (" (saved hidden)" if save else "")] = worst
        del a, g
    from tvts_torch.ops.attention import divided_space_time_attention

    for label, (B, T, N, H, d) in CORE_SHAPES.items():
        qkv = core_inputs(B, T, N, H, d, seed=3, device=dev)
        for mode in ("space", "time"):
            kernel, plain = core_calls(ac, qkv, T, N, mode)
            before = ac.divided_space_time_attention_fused.launches
            got = kernel()
            torch.cuda.synchronize()
            if ac.divided_space_time_attention_fused.launches != before + 1:
                raise AssertionError("divided_space_time_attention_fused did not count its launch")
            want = plain()
            diff, ref, tol = core_band_check(got, want)
            # and against plain in f32 on the same values: the kernel may lie no
            # farther from it than plain in bf16 does
            want32 = divided_space_time_attention(*(t.float() for t in qkv), T, N, mode)
            diff32 = (got.float() - want32).abs().max().item()
            tol32 = (want.float() - want32).abs().max().item()
            print(f"[3] divided_space_time_attention_fused {mode:5s} {label}: max|diff| "
                  f"{diff:.5f} max|ref| {ref:.4f} (tol {tol:.4f} = min({BAND}, {CORE_BAND} * "
                  f"max|ref|)); to plain in f32 {diff32:.5f} (<= plain bf16's own {tol32:.5f}); "
                  f"sha256 {sha256_of(got)}")
            if diff > tol or diff32 > tol32:
                raise AssertionError(f"H9 {mode} {label}: max|diff| {diff} > {tol}, or "
                                     f"{diff32} > {tol32} against f32")
            if label == "N=196 d=64" and mode == "space":
                max_err["divided_space_time_attention_fused"] = diff
        # H9 in f32: its own space core, the f32 time core and CLS row
        qkv32 = core_inputs(B, T, N, H, d, seed=3, device=dev, dtype=torch.float32)
        for mode in ("space", "time"):
            before = ac.divided_space_time_attention_fused.f32_launches
            diff, ref, tol, tol16 = core_f32_check(ac, qkv32, T, N, mode)
            torch.cuda.synchronize()
            if ac.divided_space_time_attention_fused.f32_launches != before + 1:
                raise AssertionError("divided_space_time_attention_fused did not count its f32 "
                                     "launch")
            controls = f32_controls(qkv32, T, N, mode)
            print(f"[3] divided_space_time_attention_fused (f32) {mode:5s} {label}: max|diff| "
                  f"to plain f32 {diff:.3e} max|ref| {ref:.4f} (tol {tol:.3e} = {F32_BAND} * "
                  f"max|ref|; <= plain bf16's own {tol16:.5f}); controls above tol: "
                  + ", ".join(f"{k} {c:.3e}" for k, c in controls.items()))
            if diff > tol or diff > tol16:
                raise AssertionError(f"H9 f32 {mode} {label}: max|diff| {diff} > {tol} or "
                                     f"> {tol16}")
            if min(controls.values()) <= tol:
                raise AssertionError(f"H9 f32 {mode} {label}: a control that is not f32 passes "
                                     f"the band {tol}: {controls}")
            if label == "N=196 d=64":
                max_err["divided_space_time_attention_fused (f32"
                        + (")" if mode == "space" else " time)")] = diff
    return max_err


def profile_phase(dev, card: str, bk, bb, ta) -> None:
    """`--profile`: the digest of the space core's patch rows, the B/16
    profiles, the space core alone, H1-H4 at B=64, the ln_gemm table, the
    saving forwards and the train step at B=20, and the extraction rates of
    B/16, B/32 (B=64) and H/14 (B=16). A copy of this script run in another
    tree of the port gives that tree's numbers for an A/B in the same call
    (a tree without `block_kernels.space_core` needs it defined first)."""
    from tvts_torch.models.factory import build_model

    space_core_rows(dev, bk)
    time_core_bwd_digests(dev, bb)
    space_core_bwd_digests(dev, bb)
    ln_bwd_digests(dev, bb)
    mma_sync_rates(dev, card, bk)
    cfg, model = build_model("TVTSv2_B_16", dtype=torch.bfloat16, device=dev, seed=0)
    add_noise_(model, 1, dev)
    v = cfg.vision
    forward_profile(cfg, model, 64, dev, card, bk)
    space_core_times(dev, card, bk, cfg, 64)
    block_times(bk, v, 64, dev, card)
    extraction_rate("6", cfg, model, 64, dev, card, iters=5)
    del model
    print(json.dumps({"ln_gemm": ln_gemm_table(dev, card, bk)}))
    print(json.dumps({"ln_rows": ln_rows_table(dev, card, bk)}))
    print(json.dumps({"wgrad": wgrad_table(dev, card, bb)[0]}))
    time_core_bwd_times(dev, card, bb)
    space_core_bwd_times(dev, card, bb)
    ln_bwd_times(dev, card, bb)
    text_core_times(dev, card, ta)
    backward_splits(dev, card, bb, ta)
    train = build_train("TVTSv2_B_16", dev, noise_seed=11, text_tune_layers=3, tag="6")
    B = 20
    batch = train_batch(train["cfg"], B, seed=13, device=dev)
    best = kernel_apply(train, "6")
    time_steps("6", "kernels", train, best, batch, card)
    profile_step("6", train, best, batch, card)
    mlp = kernel_apply(train, "6", mlp_mode="pallas")
    time_steps("6", 'kernels mlp_mode="pallas"', train, mlp, batch, card)
    profile_step("6", train, mlp, batch, card)
    v = train["cfg"].vision  # the pretraining config: n_keep patches a frame
    S, T, N, D, H = 1 + v.num_frames * v.n_keep, v.num_frames, v.n_keep, v.width, v.heads
    a = seeded_inputs(1, 1, 1, D, seed=14, device=dev)
    gen = torch.Generator(device=dev).manual_seed(15)
    for key in ("x", "base"):
        a[key] = torch.randn(B, S, D, generator=gen, device=dev, dtype=torch.bfloat16)
    w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
    with torch.inference_mode():
        for kind, core, res in (("time", "tvts_time_core", a["x"]),
                                ("space", "tvts_space_core", a["base"])):
            ms = cuda_ms(lambda: bk._attention_sub_path(core, a["x"], res, *w, T, H, save=True),
                         iters=5)
            bnd = bound_ms(*saving_forward_work(kind, B, T, N, D, H))
            print(f"[6] {kind}_subpath (saving forward) B={B} S={S}: kernel {ms:.3f} ms, bound "
                  f"{bnd[0]:.3f} ms ({bnd[1]}) [{card}]")
    del train, batch, a
    torch.cuda.empty_cache()
    for arch, B in (("TVTSv2_B_32", 64), ("TVTSv2_H_14", 16)):
        cfg, model = build_model(arch, dtype=torch.bfloat16, device=dev, seed=0)
        add_noise_(model, 1, dev)
        extraction_rate("6", cfg, model, B, dev, card, iters=3)
        del model
        torch.cuda.empty_cache()
    train = build_train("TVTSv2_H_14", dev, noise_seed=23, text_tune_layers=6, tag="8")
    every = kernel_apply(train, "8", time_mode="pallas", mlp_mode="pallas", sort_mode="pallas")
    batch = train_batch(train["cfg"], 8, seed=25, device=dev)
    time_steps("6", "every kernel", train, every, batch, card, iters=2)
    profile_step("6", train, every, batch, card)


# ---------------------------------------------------------------------------
# phase 10: the data path, from a config file and video files through the CLIs
# ---------------------------------------------------------------------------
# the three trees: (config, clips, frames a second, seconds, (height, width)),
# MSRVTT's frames 320x240 at 30 fps, UCF101's at 25 fps, SSV2's 427x240 at 12;
# 48 clips fill one batch of the configs' own batch size
DATA_TREES = {"msrvtt": ("zero-msrvtt-vit-b-16.json", 96, 30, 8, (240, 320)),
              "ucf101": ("zero-ucf101-vit-b-16.json", 48, 25, 7, (240, 320)),
              "ssv2": ("zero-ssv2-mc-vit-b-16.json", 48, 12, 4, (240, 427))}
UCF_CLASSES = ["ApplyEyeMakeup", "Archery", "BabyCrawling", "Basketball", "BenchPress",
               "Biking", "Bowling", "BoxingPunchingBag", "CliffDiving", "Drumming"]
FRAME_SEED = 10


def clip_frames(seed: int, idxs, shape: tuple[int, int]) -> np.ndarray:
    """Frames idxs of the seeded synthetic clip `seed`: uint8 [len, H, W, 3], a
    blocky colour field that scrolls two pixels a frame and a bright square
    that moves across it (content a video encoder keeps)."""
    h, w = shape
    rng = np.random.default_rng((FRAME_SEED, seed))
    field = np.kron(rng.integers(0, 256, (h // 20 + 1, w // 20 + 1, 3), dtype=np.uint8),
                    np.ones((20, 20, 1), np.uint8))[:h, :w]
    out = np.empty((len(idxs), h, w, 3), np.uint8)
    for k, t in enumerate(idxs):
        frame = np.roll(field, 2 * int(t), axis=1)
        y, x = (3 * int(t)) % (h - 40), (5 * int(t)) % (w - 40)
        frame[y:y + 40, x:x + 40] = 255
        out[k] = frame
    return out


def write_clip(path: str, seed: int, n_frames: int, fps: int, shape: tuple[int, int]) -> None:
    """An mp4v file of clip_frames (cv2 writes BGR)."""
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    h, w = shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), float(fps), (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2 cannot write {path}")
    try:
        for frame in clip_frames(seed, range(n_frames), shape)[..., ::-1]:
            writer.write(np.ascontiguousarray(frame))
    finally:
        writer.release()


def data_trees(root: str, workers: int) -> tuple[dict, dict]:
    """Write the MSRVTT, UCF101 and SSV2-MC layouts under root: metadata, the
    repo's configs with data_dir, meta_root and num_workers overridden, and
    the clips' specs ({path: (seed, frames, fps, (H, W))}). Returns
    (config path by tree, clip specs)."""
    import pickle

    meta, specs, configs = os.path.join(root, "meta"), {}, {}

    def clip(path, name):
        _, _, fps, seconds, shape = DATA_TREES[name]
        specs[path] = (len(specs), fps * seconds, fps, shape)

    # MSRVTT: jsfusion's 1k-A test ids are video7010 and up; 20 captions a video
    _, n, *_ = DATA_TREES["msrvtt"]
    data = os.path.join(root, "msrvtt")
    ids = [f"video{7010 + i}" for i in range(n)]
    captions = synthetic_captions(20 * n, seed=11)
    split = os.path.join(data, "high-quality", "structured-symlinks")
    os.makedirs(split)
    os.makedirs(os.path.join(meta, "msrvtt"))
    with open(os.path.join(meta, "msrvtt", "MSR_VTT.json"), "w") as f:
        json.dump({"annotations": [{"image_id": vid, "caption": captions[20 * i + j]}
                                   for j in range(20) for i, vid in enumerate(ids)]}, f)
    with open(os.path.join(split, "train_list_jsfusion.txt"), "w") as f:
        f.write("".join(f"video{i}\n" for i in range(10)))
    with open(os.path.join(split, "val_list_jsfusion.txt"), "w") as f:
        f.write("".join(f"{vid}\n" for vid in ids))
    with open(os.path.join(split, "jsfusion_val_caption_idx.pkl"), "wb") as f:
        pickle.dump({vid: (7 * i) % 20 for i, vid in enumerate(ids)}, f)
    for vid in ids:
        clip(os.path.join(data, "videos", "all", f"{vid}.mp4"), "msrvtt")
    configs["msrvtt"] = data

    # UCF101: testlist01 rows (relative path, label) and prompt/label2id.json
    _, n, *_ = DATA_TREES["ucf101"]
    data = os.path.join(root, "ucf101")
    os.makedirs(os.path.join(meta, "ucf101", "prompt"))
    rows = [(f"{UCF_CLASSES[i % len(UCF_CLASSES)]}/v_{UCF_CLASSES[i % len(UCF_CLASSES)]}"
             f"_g{i // len(UCF_CLASSES) + 1:02d}_c01.avi", i % len(UCF_CLASSES)) for i in range(n)]
    with open(os.path.join(meta, "ucf101", "prompt", "testlist01_new.tsv"), "w") as f:
        f.write("path\tlabel\n" + "".join(f"{rel}\t{label}\n" for rel, label in rows))
    with open(os.path.join(meta, "ucf101", "prompt", "label2id.json"), "w") as f:
        json.dump({name: i for i, name in enumerate(UCF_CLASSES)}, f)
    for rel, _ in rows:
        clip(os.path.join(data, rel), "ucf101")
    configs["ucf101"] = data

    # SSV2-MC: val.jsonl, 5 options a clip (the true label among them)
    _, n, *_ = DATA_TREES["ssv2"]
    data = os.path.join(root, "ssv2")
    os.makedirs(os.path.join(meta, "ssv2", "mc"))
    rng = np.random.default_rng(12)
    with open(os.path.join(meta, "ssv2", "mc", "val.jsonl"), "w") as f:
        for i in range(n):
            f.write(json.dumps({"clip_name": f"{100000 + i}.mp4", "answer": int(rng.integers(5)),
                                "options": synthetic_captions(5, seed=100 + i)}) + "\n")
            clip(os.path.join(data, "videos", f"{100000 + i}.mp4"), "ssv2")
    configs["ssv2"] = data

    for name, data in configs.items():
        with open(REPO / "tvts_tpu" / "configs" / DATA_TREES[name][0]) as f:
            config = json.load(f)
        config["data_loader"]["args"].update(data_dir=data, meta_root=meta, num_workers=workers)
        configs[name] = os.path.join(root, DATA_TREES[name][0])
        with open(configs[name], "w") as f:
            json.dump(config, f, indent=2)
    return configs, specs


class RecordingLoader:
    """Wraps a loader: keeps each batch it yields and the seconds the
    consumer waited in next()."""

    def __init__(self, loader):
        self.loader, self.batch_size = loader, loader.batch_size
        self.batches, self.wait_s = [], 0.0

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.wait_s += time.perf_counter() - t0
            self.batches.append(batch)
            yield batch


class ListLoader:
    """The recorded batches again, as a loader."""

    def __init__(self, batches, batch_size):
        self.batches, self.batch_size = batches, batch_size

    def __iter__(self):
        return iter(self.batches)


def recorded(module, name: str, record: dict):
    """Context: module.<name>(model, loader, ...) runs on a RecordingLoader,
    and record gets its model, loader, arguments, result and seconds."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        original = getattr(module, name)

        def wrapper(model, loader, *args, **kwargs):
            rec = RecordingLoader(loader)
            t0 = time.perf_counter()
            out = original(model, rec, *args, **kwargs)
            record.update(model=model, loader=rec, args=args, kwargs=kwargs, out=out,
                          seconds=time.perf_counter() - t0)
            return out

        setattr(module, name, wrapper)
        try:
            yield original
        finally:
            setattr(module, name, original)

    return ctx()


def timed_embed_fns(embed_mod, record: dict):
    """Context: the embed functions make_embed_fns returns add their seconds
    (synchronised) to record['video_s'] and record['text_s']."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        original = embed_mod.make_embed_fns

        def timed(fn, key):
            def call(*args):
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                record[key] = record.get(key, 0.0) + time.perf_counter() - t0
                return out
            return call

        def make(model, use_fused=False, **knobs):
            embed_text, embed_video = original(model, use_fused=use_fused, **knobs)
            return timed(embed_text, "text_s"), timed(embed_video, "video_s")

        embed_mod.make_embed_fns = make
        try:
            yield
        finally:
            embed_mod.make_embed_fns = original

    return ctx()


def injected_decode(video_reader, specs: dict):
    """Context: video_reader.get_video_len and read_frames_at serve the
    seeded clips of `specs` without decoding (for a machine with neither
    decode backend)."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = video_reader.get_video_len, video_reader.read_frames_at

        def get_video_len(path, backend="auto"):
            return specs[path][1]

        def read_frames_at(path, frame_idxs, backend="auto", resize=None):
            seed, n, _, shape = specs[path]
            frames = clip_frames(seed, [min(int(i), n - 1) for i in frame_idxs], shape)
            if resize is not None:
                from tvts_torch.data.transforms import resize_bilinear

                frames = resize_bilinear(frames, resize)
            return frames

        video_reader.get_video_len, video_reader.read_frames_at = get_video_len, read_frames_at
        try:
            yield
        finally:
            video_reader.get_video_len, video_reader.read_frames_at = saved

    return ctx()


def decode_backend(native_decoder, video_reader) -> str | None:
    """The backend the data path decodes with; the native decoder is built
    where pkg-config finds FFmpeg, and a build failure raises. None where
    neither backend exists, or where OpenCV, which writes the clips, is
    missing."""
    pkg_config = shutil.which("pkg-config")
    if pkg_config and subprocess.run([pkg_config, "--exists", *native_decoder._FFMPEG]
                                     ).returncode == 0:
        native_decoder.build()
    if video_reader._cv2() is None:
        return None
    return video_reader.pick_backend("auto")


def host_split(config_path: str, video_reader, card: str, n: int = 8) -> None:
    """Where a clip's host time goes: decode (read_frames_sampled, uniform)
    and transform (video_transform) of the first n clips of the config's test
    set, one at a time on this thread."""
    from tvts_torch.data.transforms import video_transform
    from tvts_torch.utils.config import ConfigParser, read_json

    config = ConfigParser(read_json(config_path), test=True)
    ds, _ = config.initialize_dataset_loader(config["data_loader"], {"split": "test"})
    vp = ds.video_params
    decode = transform = 0.0
    for row in ds.metadata[:n]:
        t0 = time.perf_counter()
        frames, _ = video_reader.read_frames_sampled(ds._get_video_path(row)[0],
                                                     vp["num_frames"], "uniform")
        t1 = time.perf_counter()
        video_transform(frames, vp["input_res"])
        t2 = time.perf_counter()
        decode, transform = decode + t1 - t0, transform + t2 - t1
    print(f"[10] host time a clip, one thread ({n} clips): decode {1e3 * decode / n:.2f} ms, "
          f"transform {1e3 * transform / n:.2f} ms [{card}]")


# the loader sweep of phase 10: worker counts, threads and the fork pool
SWEEP_WORKERS = (2, 4, 8)


def loader_sweep(tag: str, config_path: str, ret_eval, model, card: str) -> list[dict]:
    """clips/s from files inside extract_embeddings (the retrieval CLI's
    loader, test split, both towers on the kernels) and the host share, at
    each worker count, threads and the fork pool. The fork pool forks this
    process, which holds a CUDA context: its workers run the dataset alone
    (numpy and cv2 with its own threads off), and a fork that crashes or
    deadlocks fails the phase (loader.PROC_ITEM_TIMEOUT_S)."""
    from tvts_torch.utils.config import ConfigParser, read_json

    config = ConfigParser(read_json(config_path), test=True)
    rows = []
    for pool in ("threads", "fork"):
        for workers in SWEEP_WORKERS:
            _, loader = config.initialize_dataset_loader(
                config["data_loader"], {"split": "test", "shuffle": False,
                                        "num_workers": workers})
            loader.use_processes = pool == "fork"
            rec = RecordingLoader(loader)
            t0 = time.perf_counter()
            n = len(ret_eval.extract_embeddings(model, rec, use_fused=True)["video"])
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rows.append({"pool": pool, "workers": workers, "clips": n,
                         "clips_s": n / sec, "host_share": rec.wait_s / sec})
            print(f"[{tag}] loader sweep: {pool:7s} {workers} workers: {n} clips in "
                  f"{sec:.3f} s = {n / sec:.2f} clips/s from files, host share "
                  f"{rec.wait_s / sec:.3f} [{card}]")
    return rows


def data_phase(dev, card: str, ext: dict, bk, bb, ta) -> dict:
    """Phase 10 (module notes). Returns the retrieval CLI's rates."""
    import tempfile

    from tvts_torch.cli import feature_extraction as fe_cli
    from tvts_torch.cli import zero_recognition as rec_cli
    from tvts_torch.cli import zero_ret as ret_cli
    from tvts_torch.cli import zero_ssv2_mc as mc_cli
    from tvts_torch.data import native_decoder, video_reader
    from tvts_torch.eval import embed as embed_mod
    from tvts_torch.eval import zero_ret as ret_eval
    from tvts_torch.eval.embed import _pad_to, embed_texts, make_embed_fns
    from tvts_torch.eval.feature_extraction import extract_video_feature, load_clip_for_extraction
    from tvts_torch.ops import metrics as metrics_mod
    from tvts_torch.ops.sim import sim_matrix

    cfg, model32 = ext["cfg"], ext["model32"]
    v, tc = cfg.vision, cfg.text
    workers = len(os.sched_getaffinity(0))
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="tvts_data_phase_") as root:
        configs, specs = data_trees(root, workers)
        backend = decode_backend(native_decoder, video_reader)
        t0 = time.perf_counter()
        if backend is None:
            print("[10] " + json.dumps({"decode_backend": None, "frames": f"from seed {FRAME_SEED}, "
                                        "injected at video_reader.read_frames_at"}))
            decode = injected_decode(video_reader, specs)
        else:
            with cf.ThreadPoolExecutor(workers) as pool:
                list(pool.map(lambda item: write_clip(item[0], item[1][0], item[1][1], item[1][2],
                                                      item[1][3]), specs.items()))
            import cv2

            print("[10] " + json.dumps({
                "decode_backend": backend, "cv2": cv2.__version__,
                "native_decoder": "built" if native_decoder.available() else
                native_decoder.unavailable_reason(),
                "clips_written": len(specs), "frames_written": sum(s[1] for s in specs.values()),
                "write_s": round(time.perf_counter() - t0, 3)}))
            import contextlib

            decode = contextlib.nullcontext()
        ckpt = os.path.join(root, "TVTSv2_B_16_seeded.pth")
        torch.save({k: t.cpu() for k, t in model32.state_dict().items()}, ckpt)
        common = ["--load_checkpoint", ckpt, "--bf16"]
        with decode:
            # retrieval: from the config and the clips through H1-H4 and H7
            record: dict = {}
            reset_launch_counts(bk, bb, ta)
            t0 = time.perf_counter()
            with recorded(ret_eval, "extract_embeddings", record), \
                    timed_embed_fns(embed_mod, record):
                metrics, _ = ret_cli.main(["-c", configs["msrvtt"], "--fused", *common])
            cli_s = time.perf_counter() - t0
            launches = launch_counts(bk, bb, ta)
            out, batches, bsz = record["out"], record["loader"].batches, record["loader"].batch_size
            n_clips, n_fwd = len(out["video"]), len(batches)
            print(f"[10] retrieval CLI: {n_clips} clips in {n_fwd} batches of {bsz}; launches "
                  f"{ {k: n for k, n in launches.items() if n} }")
            want = {name: n * n_fwd for name, n in ext["per_forward"].items()}
            want["fused_text_attention_block"] = want["text_core"] = (tc.layers - 1) * n_fwd
            expect_launches("retrieval CLI", launches, want)
            model = record["model"]
            paths = {}
            for path, use_fused in (("kernels", True), ("eager", False)):
                embed_text, embed_video = make_embed_fns(model, use_fused=use_fused)
                vids, txts = [], []
                for batch in batches:
                    n = len(batch["video"])
                    vids.append(embed_video(
                        torch.from_numpy(_pad_to(batch["video"], bsz)).to(dev),
                        torch.from_numpy(_pad_to(batch["keep_ind"].astype(np.int64), bsz)).to(dev)
                    ).float().cpu().numpy()[:n])
                    txts.append(embed_texts(embed_text, batch["text"], dev, tc.context_length, bsz))
                paths[path] = np.concatenate(vids), np.concatenate(txts)
            same = (np.array_equal(paths["kernels"][0], out["video"])
                    and np.array_equal(paths["kernels"][1], out["text"]))
            cv = cos_rows(out["video"], paths["eager"][0]).min()
            ct = cos_rows(out["text"], paths["eager"][1]).min()
            print(f"[10] retrieval CLI embeddings: bit for bit make_embed_fns(use_fused=True) on "
                  f"the loader's batches: {same}; cosine to eager (bf16) min video {cv:.6f}, "
                  f"text {ct:.6f} (>= {COS_BF16})")
            if not same or cv < COS_BF16 or ct < COS_BF16 \
                    or not np.isfinite(out["video"]).all():
                raise AssertionError("retrieval CLI: embeddings disagree")
            sims = sim_matrix(torch.from_numpy(paths["eager"][1]),
                              torch.from_numpy(paths["eager"][0])).numpy()
            eager_metrics = {name: getattr(metrics_mod, name)(sims)
                             for name in ("t2v_metrics", "v2t_metrics")}
            for label, res in (("kernels (CLI)", metrics), ("eager", eager_metrics)):
                print(f"[10] retrieval {label}: " + json.dumps(res))
            loader_s, video_s, text_s = (record["loader"].wait_s, record.get("video_s", 0.0),
                                         record.get("text_s", 0.0))
            rates = {"clips_s": n_clips / record["seconds"], "host_share":
                     loader_s / record["seconds"], "workers": workers}
            print(f"[10] retrieval CLI from files: {n_clips} clips in {record['seconds']:.3f} s "
                  f"inside extract_embeddings = {rates['clips_s']:.2f} clips/s; waiting on the "
                  f"loader {loader_s:.3f} s (host share {rates['host_share']:.3f}), embed_video "
                  f"{video_s:.3f} s, embed_text {text_s:.3f} s; the whole CLI {cli_s:.3f} s "
                  f"(model build and checkpoint load included); {workers} workers, decode "
                  f"{backend or 'injected'} [{card}]")
            rates["sweep"] = loader_sweep("10", configs["msrvtt"], ret_eval, model, card)
            del model, record, batches
            host_split(configs["msrvtt"], video_reader, card)

            # feature extraction from a file, against the array entry
            path = next(iter(specs))
            out_npy = os.path.join(root, "embedding.npy")
            reset_launch_counts(bk, bb, ta)
            fe_cli.main(["--arch", cfg.name, "--video_path", path, "--fused", "--out",
                         out_npy, *common])
            expect_launches("feature extraction CLI", launch_counts(bk, bb, ta),
                            ext["per_forward"])
            saved = np.load(out_npy)
            want = extract_video_feature(ext["model"], load_clip_for_extraction(path),
                                         use_fused=True)
            fast = extract_video_feature(ext["model"], path, use_fused=True, fast_pipeline=True)
            print(f"[10] feature extraction CLI: {saved.shape}, bit for bit the array entry on "
                  f"the same clip: {np.array_equal(saved, want)}; --fast_pipeline cosine to it "
                  f"{cos_rows(fast, want)[0]:.6f}")
            if not np.array_equal(saved, want) or not np.isfinite(fast).all():
                raise AssertionError("feature extraction CLI disagrees with the array entry")

            # recognition and SSV2-MC, against the in-memory calls on the same batches
            for label, cli, name, keys in (
                    ("recognition", rec_cli, "run_recognition", ("top1", "top5")),
                    ("SSV2-MC", mc_cli, "run_ssv2_mc", ("accuracy", "correct", "total"))):
                record = {}
                config = configs["ucf101" if cli is rec_cli else "ssv2"]
                argv = ["-c", config, *common]
                if cli is rec_cli:
                    argv += ["--meta_root", os.path.join(root, "meta")]
                with recorded(cli, name, record) as original:
                    got = cli.main(argv)
                    again = original(record["model"], ListLoader(record["loader"].batches,
                                                                 record["loader"].batch_size),
                                     *record["args"], **record["kwargs"])
                print(f"[10] {label} CLI over {len(record['loader'].batches)} batch(es): "
                      + ", ".join(f"{k} {got[k]}" for k in keys) + "; in memory on the same "
                      "batches: " + ", ".join(f"{k} {again[k]}" for k in keys))
                if any(got[k] != again[k] for k in keys):
                    raise AssertionError(f"{label} CLI disagrees with the in-memory call")
                del record
            torch.cuda.empty_cache()
    print(f"[10] data phase {time.perf_counter() - t_phase:.1f} s")
    return rates


# ---------------------------------------------------------------------------
# phase 11: pretraining from files, the config's two loaders into the B/16 step
# ---------------------------------------------------------------------------
PRETRAIN_CONFIG = "dist-yt-web-pt-vit-b-16-fused.json"
# (videos, seconds, frames a second, (height, width)): YT-Temporal's 320x240
# at 30 fps, 30 s, so that every window of randint(3, 6) * 4 + 3 s fits with
# a random start; WebVid's 596x336 at 25 fps, 10 s
YTT_TREE = (48, 30, 30, (240, 320))
WEBVID_TREE = (48, 10, 25, (336, 596))
ASR_WORDS_S = 2.5  # words a second of the synthetic ASR
JUNK_WORDS = ("&amp;", "&gt;", "&#39;", "amp;")


def asr_annotation(seed: int, duration: float, words_s: float = ASR_WORDS_S) -> dict:
    """A YT-Temporal annotation: `subtitles` (word and time, with a few
    HTML-entity junk words that clean_subtitles drops), `denoised` (cleanasr
    sentences of the same words with other case and punctuation and a few
    words dropped or inserted, so the DTW has real work) and info.duration."""
    rng = np.random.default_rng((13, seed))
    n = int(duration * words_s)
    times = np.sort(rng.uniform(0.0, duration, n))
    words = [str(w) for w in rng.choice(WORDS, n)]
    subtitles = [{"word": w, "time": round(float(t), 2)} for w, t in zip(words, times)]
    for k in sorted(rng.choice(n, max(1, n // 30), replace=False), reverse=True):
        subtitles.insert(int(k), {"word": str(rng.choice(JUNK_WORDS)),
                                  "time": subtitles[k]["time"]})
    denoised = []
    for w in words:
        r = rng.random()
        if r < 0.04:
            continue  # dropped
        if r < 0.2:
            w = w.capitalize()
        if rng.random() < 0.1:
            w += str(rng.choice([",", ".", "?", "!"]))
        denoised.append(w)
        if rng.random() < 0.04:
            denoised.append(str(rng.choice(WORDS)))  # inserted
    sentences = [" ".join(denoised[i:i + 12]) for i in range(0, len(denoised), 12)]
    return {"subtitles": subtitles, "denoised": [{"cleanasr": s} for s in sentences],
            "info": {"duration": duration}}


def pretrain_trees(root: str, args: dict, video_params: dict | None = None,
                   ytt=YTT_TREE, webvid=WEBVID_TREE, val: int = 0,
                   words_s: float = ASR_WORDS_S) -> tuple[str, dict]:
    """Write the YT-Temporal layout (meta/yttemporal_train.csv, a tsv with a
    Name column; ytt/videos/<channel>/<id>.mp4 and their
    annotations/<id>.json) and the WebVid one (meta/webvid_train.tsv,
    webvid/train/<id>.mp4) under root, and the repo's pretraining config with
    data_dir and meta_root set and `args` (and `video_params`) merged into
    both loaders. `val`: the val splits hold the first `val` videos of each
    (yttemporal_val.csv; webvid_val.tsv over webvid/val/<id>.mp4, links to
    the train clips); `words_s`: ASR words a second. Returns (config path,
    clip specs {path: (seed, frames, fps, (H, W))}); the clips themselves are
    written by write_clip."""
    meta, specs = os.path.join(root, "meta"), {}
    os.makedirs(meta)
    n, seconds, fps, shape = ytt
    names = [f"channel{i % 4}/yt{i:04d}.mp4" for i in range(n)]
    for split, rows in (("train", names), ("val", names[:val]))[:1 + bool(val)]:
        with open(os.path.join(meta, f"yttemporal_{split}.csv"), "w") as f:
            f.write("Name\n" + "".join(f"{name}\n" for name in rows))
    ytt_dir = os.path.join(root, "ytt")
    for i, name in enumerate(names):
        channel, vid = name.split("/")
        ann_dir = os.path.join(ytt_dir, "videos", channel, "annotations")
        os.makedirs(ann_dir, exist_ok=True)
        with open(os.path.join(ann_dir, vid[:-4] + ".json"), "w") as f:
            json.dump(asr_annotation(i, seconds, words_s), f)
        specs[os.path.join(ytt_dir, "videos", name)] = (1000 + i, fps * seconds, fps, shape)
    n, seconds, fps, shape = webvid
    web_dir = os.path.join(root, "webvid")
    captions = synthetic_captions(n, seed=14)
    for split, k in (("train", n), ("val", val))[:1 + bool(val)]:
        with open(os.path.join(meta, f"webvid_{split}.tsv"), "w") as f:
            f.write("name\tvideoid\n"
                    + "".join(f"{c}\t{2000 + i}\n" for i, c in enumerate(captions[:k])))
    for i in range(n):
        specs[os.path.join(web_dir, "train", f"{2000 + i}.mp4")] = (2000 + i, fps * seconds, fps,
                                                                    shape)
    if val:
        os.makedirs(os.path.join(web_dir, "val"))
        for i in range(val):
            os.symlink(os.path.join(web_dir, "train", f"{2000 + i}.mp4"),
                       os.path.join(web_dir, "val", f"{2000 + i}.mp4"))
    with open(REPO / "tvts_tpu" / "configs" / PRETRAIN_CONFIG) as f:
        config = json.load(f)
    for spec in config["data_loader"]:
        spec["args"].update(args, meta_root=meta,
                            data_dir=ytt_dir if spec["args"]["dataset_name"] == "YTTemporal"
                            else web_dir)
        spec["args"]["video_params"].update(video_params or {})
    path = os.path.join(root, PRETRAIN_CONFIG)
    with open(path, "w") as f:
        json.dump(config, f, indent=2)
    return path, specs


def write_clips(specs: dict, workers: int) -> None:
    """write_clip every clip of `specs`, `workers` at a time."""
    with cf.ThreadPoolExecutor(workers) as pool:
        list(pool.map(lambda item: write_clip(item[0], *item[1]), specs.items()))


def alternating(loaders):
    """The loaders' batches in turn (one of each, as the Trainer's round
    robin takes them) while every loader has one."""
    its = [iter(loader) for loader in loaders]
    while True:
        for it in its:
            batch = next(it, None)
            if batch is None:
                return
            yield batch


def ytt_host_split(ds, video_reader, card: str, n: int = 8) -> None:
    """Where a YT-Temporal item's host time goes, one item at a time on this
    thread: get_caption_multi (the annotation, its cleaning and the DTW
    alignment, the DTW apart), the multi-clip decode and the transform, over
    the first n videos; then get_caption_multi alone on a realistic
    annotation of 600 ASR words (a 4-minute video at 2.5 words a second)."""
    import tempfile

    from tvts_torch.data import ytt as ytt_mod
    from tvts_torch.data.transforms import video_transform

    dtw = [0.0]
    original = ytt_mod.align_using_dtw

    def timed_dtw(*args):
        t0 = time.perf_counter()
        out = original(*args)
        dtw[0] += time.perf_counter() - t0
        return out

    ytt_mod.align_using_dtw = timed_dtw
    try:
        caption = decode = transform = 0.0
        rng = np.random.default_rng(0)
        for name in ds.metadata[:n]:
            t0 = time.perf_counter()
            _, _, starts, ends, duration = ds.get_caption_multi(ds.get_caption_path(name), rng)
            t1 = time.perf_counter()
            frames = video_reader.read_multi_clip(ds._get_video_path(name)[0], starts, ends,
                                                  duration, ds.num_frames, ds.num_clips, rng=rng,
                                                  backend=ds.reader)
            t2 = time.perf_counter()
            video_transform(frames, crop_size=ds.input_res, mode="train", rng=rng)
            t3 = time.perf_counter()
            caption, decode, transform = caption + t1 - t0, decode + t2 - t1, transform + t3 - t2
        print(f"[11] host time a YT-Temporal item, one thread ({n} items, "
              f"{len(asr_annotation(0, YTT_TREE[1])['subtitles'])} subtitle words each): "
              f"caption and DTW {1e3 * caption / n:.2f} ms (DTW {1e3 * dtw[0] / n:.2f}), decode "
              f"{1e3 * decode / n:.2f} ms, transform {1e3 * transform / n:.2f} ms [{card}]")
        with tempfile.TemporaryDirectory(prefix="tvts_asr_") as root:
            path = os.path.join(root, "long.json")
            ann = asr_annotation(99, 240.0)
            with open(path, "w") as f:
                json.dump(ann, f)
            dtw[0], reps = 0.0, 3
            t0 = time.perf_counter()
            for _ in range(reps):
                ds.get_caption_multi(path, rng)
            sec = (time.perf_counter() - t0) / reps
        print(f"[11] get_caption_multi on a 600-word annotation ({len(ann['subtitles'])} "
              f"subtitle words, 240 s), one thread: {1e3 * sec:.2f} ms, of which DTW "
              f"{1e3 * dtw[0] / reps:.2f} ms [{card}]")
    finally:
        ytt_mod.align_using_dtw = original


# phase 12 trains 6 steps a loader an epoch: 72 YT-Temporal train videos; the
# val splits hold the first 24 videos of each layout (2 batches each)
PRETRAIN_YTT_TREE = (72, *YTT_TREE[1:])
PRETRAIN_VAL = 24


def pretrain_files(root: str, tag: str) -> tuple[str, object, str | None]:
    """The YT-Temporal and WebVid layouts of phases 11 and 12 under root, the
    config's loaders at the machine's cores: (config path, the decode
    context: seeded frames injected where no backend exists, the backend)."""
    import contextlib

    from tvts_torch.data import native_decoder, video_reader

    workers = len(os.sched_getaffinity(0))
    config_path, specs = pretrain_trees(root, {"num_workers": workers}, ytt=PRETRAIN_YTT_TREE,
                                        val=PRETRAIN_VAL)
    backend = decode_backend(native_decoder, video_reader)
    if backend is None:
        print(f"[{tag}] " + json.dumps({"decode_backend": None, "frames": "from their seeds, "
                                        "injected at video_reader.read_frames_at"}))
        return config_path, injected_decode(video_reader, specs), None
    t0 = time.perf_counter()
    write_clips(specs, workers)
    print(f"[{tag}] " + json.dumps({
        "decode_backend": backend, "clips_written": len(specs),
        "frames_written": sum(spec[1] for spec in specs.values()),
        "write_s": round(time.perf_counter() - t0, 3)}))
    return config_path, contextlib.nullcontext(), backend


def pretrain_phase(dev, card: str, bk, bb, ta, config_path: str, backend: str | None) -> dict:
    """Phase 11 (module notes): pretraining from files. Returns its rates."""
    from functools import partial

    from tvts_torch.data import video_reader
    from tvts_torch.data.prefetch import prefetch_to_device
    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.ops.kernel_config import resolve_kernel_config, train_apply_kwargs
    from tvts_torch.train.step import make_train_step
    from tvts_torch.train.trainer import prepare_batch
    from tvts_torch.utils.config import ConfigParser, read_json

    t_phase = time.perf_counter()
    config = ConfigParser(read_json(config_path), test=True)
    datasets, loaders = zip(*(config.initialize_dataset_loader(spec)
                              for spec in config["data_loader"]))
    print(f"[11] {PRETRAIN_CONFIG}: " + ", ".join(
        f"{type(ds).__name__} {len(ds)} videos, batch {ld.batch_size}, {ld.num_workers} "
        f"workers" for ds, ld in zip(datasets, loaders)))
    arch = config["arch"]["type"]
    train = build_train(arch, dev, noise_seed=21, text_tune_layers=3, tag="11")
    cfg, model = train["cfg"], train["model"]
    L, TL = cfg.vision.layers, cfg.text.layers
    kcfg = resolve_kernel_config(arch, config["trainer"]["kernels"])
    kwargs = train_apply_kwargs(kcfg, train["ocfg"])
    print(f"[11] trainer.kernels {config['trainer']['kernels']} -> {kwargs}")
    apply_fn = partial(train_apply, **kwargs)
    step = make_train_step(model, train["optimizer"], train["ocfg"], apply_fn=apply_fn)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    v, n_clips = cfg.vision, cfg.num_clips
    B = loaders[0].batch_size

    host, snaps, losses = [], [], []

    def fed():  # the host batches, kept for the bit-for-bit check
        for batch in alternating(loaders):
            host.append(prepare_batch(batch))
            yield host[-1]

    n_steps, window = 8, range(2, 8)  # time steps 3-8
    feed = prefetch_to_device(fed(), size=2, device=dev)
    wait = t_window = 0.0
    for i in range(n_steps):
        if i == window[0]:
            torch.cuda.synchronize()
            t_window = time.perf_counter()
        t0 = time.perf_counter()
        batch = next(feed)
        if i in window:
            wait += time.perf_counter() - t0
        # a copy on this stream, right behind the prefetcher's event: what the step reads
        snaps.append({k: t.clone() for k, t in batch.items()})
        ytt = "labels" in batch
        if i == 0:
            hb = host[0]
            shapes = {k: tuple(a.shape) for k, a in hb.items()}
            print(f"[11] first YT-Temporal batch from files: {shapes}")
            want = {"video": (B, v.num_frames, 3, v.input_resolution, v.input_resolution),
                    "keep_ind": (B, v.n_keep), "text_ids": (n_clips * B, 77),
                    "labels": (B, n_clips)}
            if not ytt or shapes != want or hb["video"].dtype != np.float32 \
                    or not (hb["labels"] == np.arange(n_clips)).all():
                raise AssertionError(f"YT-Temporal batch: {shapes}, expected {want}")
            got = step0_gate("11", "step 0 from files", model, batch, apply_fn,
                             bk, bb, ta)
            expect_launches("step 0 from files", got, step_launches(L, TL, 9))
        reset_launch_counts(bk, bb, ta)
        aux = {k: t.item() for k, t in step(batch).items()}
        launches = launch_counts(bk, bb, ta)
        expect_launches(f"step {i + 1} from files ({'YT-Temporal' if ytt else 'WebVid'})",
                        launches, step_launches(L, TL, 9, sort=ytt))
        losses.append(aux["loss"])
        print(f"[11] step {i + 1} ({'YT-Temporal' if ytt else 'WebVid'}, "
              f"{batch['text_ids'].shape[0]} captions): "
              + ", ".join(f"{k} {x:.6f}" for k, x in aux.items())
              + f"; launches {sum(launches.values())} (as phase 7, "
              f"{'with' if ytt else 'without'} the sort head)")
        if not all(np.isfinite(list(aux.values()))):
            raise AssertionError(f"step {i + 1} from files: non-finite {aux}")
    torch.cuda.synchronize()
    sec = time.perf_counter() - t_window
    same = all(torch.equal(snap[k].cpu(), torch.from_numpy(np.ascontiguousarray(hb[k])))
               for snap, hb in zip(snaps, host) for k in hb)
    print(f"[11] prefetched batches bit for bit the host batches ({len(snaps)} batches, "
          f"every array): {same}")
    if not same or len(snaps) != n_steps:
        raise AssertionError("prefetched batches differ from the host batches")
    changed = [n for n in train["frozen"]
               if not torch.equal(dict(model.named_parameters())[n].detach(), before[n])]
    if changed:
        raise AssertionError(f"frozen tensors changed: {changed}")
    print(f"[11] {n_steps} steps from files, finite losses; {len(train['frozen'])} frozen "
          f"tensors unchanged bit for bit")
    clips = B * len(window)
    rates = {"clips_s": clips / sec, "host_share": wait / sec}
    ytt_host_split(datasets[0], video_reader, card)
    del snaps, host
    # the same step on a device-resident batch (the first from files), each loader's kind
    resident = {}
    for label, hb in (("YT-Temporal", 0), ("WebVid", 1)):
        batch = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for k, a in prepare_batch(next(iter(loaders[hb]))).items()}
        ms = time_steps("11", f"{label} B={B} device-resident", train, apply_fn, batch, card)
        resident[label] = B / (ms / 1e3)
    rates["resident_clips_s"] = sum(resident.values()) / len(resident)
    print(f"[11] pretraining from files (YT-Temporal and WebVid in turn, B={B}): "
          f"{rates['clips_s']:.2f} clips/s over steps 3-8, host share {rates['host_share']:.3f} "
          f"(seconds waiting on the prefetcher over that window); device-resident "
          f"{resident['YT-Temporal']:.2f} (YT-Temporal) / {resident['WebVid']:.2f} (WebVid) "
          f"clips/s; {loaders[0].num_workers} workers a loader, decode "
          f"{backend or 'injected'} [{card}]")
    print(f"[11] pretraining phase {time.perf_counter() - t_phase:.1f} s")
    del train, model
    torch.cuda.empty_cache()
    return rates


# ---------------------------------------------------------------------------
# phase 12: the Trainer on the card, through the train CLI
# ---------------------------------------------------------------------------
TRAINER_STEPS = 6  # optimizer steps a loader an epoch
TRAINER_WINDOW = range(2, 12)  # steps 3-12 of epoch 1 (0-based), after two of warm-up


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def patched(*patches):
    """Context: setattr(obj, name, value) for each (obj, name, value), undone on exit."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
        for obj, name, value in patches:
            setattr(obj, name, value)
        try:
            yield
        finally:
            for obj, name, value in saved:
                setattr(obj, name, value)

    return ctx()


def trainer_hooks(bk, bb, ta, record: dict):
    """Context: the Trainer's steps, batch waits, validations, checkpoint
    writes and resume recorded into `record` (each step's launches, its aux
    on the device; the window's host clock, synchronised at both ends)."""
    from tvts_torch.train import step as step_mod, trainer as trainer_mod
    from tvts_torch.utils import checkpoint as ckpt_mod

    step_call = step_mod.TrainStep.__call__
    pipeline = trainer_mod.Trainer._pipeline
    valid = trainer_mod.Trainer._valid_epoch
    resume = trainer_mod.Trainer.resume
    save = ckpt_mod.save_reference_checkpoint

    def counted_step(self, batch):
        reset_launch_counts(bk, bb, ta)
        aux = step_call(self, batch)
        record["steps"].append(("labels" in batch, launch_counts(bk, bb, ta), aux))
        i = len(record["steps"]) - 1
        if i in (TRAINER_WINDOW.start - 1, TRAINER_WINDOW.stop - 1):
            torch.cuda.synchronize()
            record["t0" if i < TRAINER_WINDOW.start else "t1"] = time.perf_counter()
        return aux

    def timed_pipeline(self, dl):
        it = pipeline(self, dl)

        def batches():
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    return
                record["waits"].append((len(record["steps"]), time.perf_counter() - t0))
                yield batch

        return batches()

    def timed_valid(self, epoch):
        t0 = time.perf_counter()
        log = valid(self, epoch)
        record["vals"].append((epoch, log, time.perf_counter() - t0))
        return log

    def timed_save(model, path, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(model, path, *args, **kwargs)
        record["saves"].append((os.path.basename(path), time.perf_counter() - t0,
                                os.path.getsize(path)))

    def checked_resume(self, tag=None):
        nxt = resume(self, tag)
        saved = torch.load(tag, map_location="cpu", weights_only=True)
        state = self.optimizer.state_dict()["state"]
        record["resume"] = {
            "next_epoch": nxt,
            "parameters": all(torch.equal(v.cpu(), saved["state_dict"][f"module.{k}"])
                              for k, v in self.model.state_dict().items()),
            "adamw_state": sorted(state) == sorted(saved["optimizer"]["state"]) and all(
                torch.equal(torch.as_tensor(v).cpu(), torch.as_tensor(saved["optimizer"]["state"][i][k]))
                for i, st in state.items() for k, v in st.items()),
            "step": (self.train_step.count, saved["step"]),
            "monitor_best": (self.ckpt.monitor.best, saved["monitor_best"])}
        return nxt

    return patched((step_mod.TrainStep, "__call__", counted_step),
                   (trainer_mod.Trainer, "_pipeline", timed_pipeline),
                   (trainer_mod.Trainer, "_valid_epoch", timed_valid),
                   (trainer_mod.Trainer, "resume", checked_resume),
                   (ckpt_mod, "save_reference_checkpoint", timed_save))


def check_trainer_steps(tag: str, steps: list, L: int, TL: int) -> None:
    """Finite losses, and each step's launches phase 7's (with or without the sort head)."""
    for i, (ytt, launches, _) in enumerate(steps):
        expect_launches(f"Trainer step {i + 1}", launches, step_launches(L, TL, 9, sort=ytt))
    losses = torch.stack([aux["loss"].float() for _, _, aux in steps]).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"Trainer steps: non-finite losses {losses.tolist()}")
    counts = sorted({sum(launches.values()) for _, launches, _ in steps})
    total = {k: sum(launches[k] for _, launches, _ in steps) for k in steps[0][1]}
    print(f"[{tag}] {len(steps)} Trainer steps, finite losses (first {losses[0].item():.6f}, "
          f"last {losses[-1].item():.6f}); launches a step {counts} (as phase 7: 219 with the "
          f"sort head, 212 without); over the steps: "
          + json.dumps({k: n for k, n in total.items() if n}))


def trainer_phase(dev, card: str, bk, bb, ta, root: str, config_path: str, bare: dict) -> None:
    """Phase 12 (module notes): the Trainer through tvts_torch.cli.train_dist_TVTSv2."""
    import torch.distributed as dist

    from tvts_torch.cli import train_dist_TVTSv2 as cli
    from tvts_torch.models.configs import MODEL_REGISTRY
    from tvts_torch.models.factory import build_model
    from tvts_torch.train.step import make_eval_step
    from tvts_torch.train.trainer import prepare_batch
    from tvts_torch.utils.config import read_json, write_json

    t_phase = time.perf_counter()
    config = read_json(config_path)
    B = config["data_loader"][0]["args"]["batch_size"]
    results = os.path.join(root, "results")
    edits = {"epochs": 2, "max_samples_per_epoch": TRAINER_STEPS * B, "save_dir": results}
    config["trainer"].update(edits)
    path = os.path.join(root, "phase12.json")
    write_json(config, path)
    arch = config["arch"]["type"]
    cfg = MODEL_REGISTRY[arch]()
    L, TL = cfg.vision.layers, cfg.text.layers
    print(f"[12] {PRETRAIN_CONFIG} edited in data_dir, meta_root, num_workers "
          f"({config['data_loader'][0]['args']['num_workers']}) and trainer {edits}; "
          f"init_val {config['trainer']['init_val']}, monitor "
          f"{config['trainer']['monitor']!r}, kernels {config['trainer']['kernels']}; "
          f"val splits of {PRETRAIN_VAL} videos each")
    record = {"steps": [], "waits": [], "vals": [], "saves": []}
    try:
        argv = ["-c", path, "--num_processes", "1", "--process_id", "0"]
        with trainer_hooks(bk, bb, ta, record):
            trainer = cli.main([*argv, "--coordinator", f"localhost:{free_port()}"])
        if dist.is_initialized():
            raise AssertionError("the train CLI left its process group")
        steps = record["steps"]
        if len(steps) != 2 * 2 * TRAINER_STEPS or trainer.train_step.count != len(steps):
            raise AssertionError(f"{len(steps)} Trainer steps, count {trainer.train_step.count}")
        check_trainer_steps("12", steps, L, TL)
        sec = record["t1"] - record["t0"]
        wait = sum(w for i, w in record["waits"] if i in TRAINER_WINDOW)
        clips = B * len(TRAINER_WINDOW)
        print(f"[12] the Trainer (1-rank NCCL group, the mesh step) over steps "
              f"{TRAINER_WINDOW.start + 1}-{TRAINER_WINDOW.stop} of epoch 1: {clips / sec:.2f} "
              f"clips/s, host share {wait / sec:.3f}; phase 11's bare loop from the same "
              f"files {bare['clips_s']:.2f} clips/s, host share {bare['host_share']:.3f}; "
              f"device-resident {bare['resident_clips_s']:.2f} [{card}]")
        print(f"[12] seconds waiting on the feed before each step of that window: "
              + json.dumps([round(w, 4) for i, w in record["waits"] if i in TRAINER_WINDOW])
              + f"; WebVid restarts its loader at step {2 * 4 + 2} (4 batches of {B})")
        for epoch, log, seconds in record["vals"]:
            print(f"[12] validation epoch {epoch} ({seconds:.2f} s): " + json.dumps(
                {k: round(v, 6) for k, v in log.items() if np.isscalar(v)}))
        if [e for e, _, _ in record["vals"]] != [0, 1, 2]:
            raise AssertionError(f"validations {[e for e, _, _ in record['vals']]}, expected "
                                 "the init one and one an epoch")
        for name, seconds, size in record["saves"]:
            print(f"[12] saved {name}: {size / 2 ** 30:.3f} GiB in {seconds:.2f} s "
                  f"({size / 2 ** 30 / seconds:.2f} GiB/s) [{card}]")
        save_dir = trainer.ckpt.save_dir
        names = sorted(os.listdir(save_dir))
        if not {"checkpoint-epoch1.pth", "checkpoint-epoch2.pth", "model_best.pth"} <= set(names):
            raise AssertionError(f"checkpoints written: {names}")
        # the epoch-2 file, built strictly, against the trained model
        val = trainer.valid_loaders[0]
        batch = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for k, a in prepare_batch(next(iter(val))).items()}
        want = make_eval_step(trainer.model, apply_fn=trainer.train_step.fwd)(batch)
        _, loaded = build_model(arch, load_checkpoint=os.path.join(save_dir,
                                                                   "checkpoint-epoch2.pth"),
                                eval_mode=False, device=dev, compute_dtype=torch.bfloat16)
        got = make_eval_step(loaded, apply_fn=trainer.train_step.fwd)(batch)
        same = all(torch.equal(got[k], want[k]) for k in ("video_emb", "text_emb", "sort_acc"))
        print(f"[12] build_model(load_checkpoint=checkpoint-epoch2.pth), strict: embeddings of "
              f"a val batch ({batch['video'].shape[0]} clips) bit for bit the trained "
              f"model's: {same}")
        if not same:
            raise AssertionError("a strict reload of the epoch checkpoint disagrees")
        del trainer, loaded, want, got
        torch.cuda.empty_cache()
        # resume from the epoch-1 file: state bit for bit, then epoch 2 runs
        record.update(steps=[], waits=[], vals=[], saves=[])
        epoch1 = os.path.join(save_dir, "checkpoint-epoch1.pth")
        with trainer_hooks(bk, bb, ta, record):
            resumed = cli.main([*argv, "--coordinator", f"localhost:{free_port()}",
                                "-r", epoch1])
        res = record["resume"]
        print(f"[12] -r checkpoint-epoch1.pth: " + json.dumps(res))
        if not (res["parameters"] and res["adamw_state"] and res["next_epoch"] == 2
                and res["step"][0] == res["step"][1] == 2 * TRAINER_STEPS
                and res["monitor_best"][0] == res["monitor_best"][1]):
            raise AssertionError(f"resume restored another state: {res}")
        check_trainer_steps("12", record["steps"], L, TL)
        if resumed.train_step.count != 4 * TRAINER_STEPS or \
                [e for e, _, _ in record["vals"]] != [2]:
            raise AssertionError("the resumed epoch did not run")
        print(f"[12] the resumed epoch 2 ran: {len(record['steps'])} steps, validation, "
              f"{[name for name, _, _ in record['saves']]} written")
        del resumed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(results, ignore_errors=True)
    print(f"[12] Trainer phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: parameter and optimizer-state sharding (parallel/partition.py's
# fsdp_shard) through the kernel steps, on a 1-rank NCCL group
# ---------------------------------------------------------------------------
FSDP_B = 12  # phase 11's batch
FSDP_STEPS = 3


def one_rank_mesh(dev):
    """A 1-rank process group on `dev` (NCCL on the card) and its (dp, fsdp)
    DeviceMesh, closed on exit."""
    from tvts_torch.parallel.mesh import create_mesh

    return create_mesh(coordinator=f"localhost:{free_port()}", num_processes=1, process_id=0,
                       device=dev.type)


def sharded_copy(model, mesh):
    """A copy of `model` sharded over the mesh's fsdp group (every block of
    both towers and the sort head a unit, then the root)."""
    import copy

    from tvts_torch.parallel.partition import fsdp_shard

    return fsdp_shard(copy.deepcopy(model), mesh)


# the host ranges of parallel/tensor_parallel.py's autograd Functions
TP_FUNCTIONS = ("_Gather", "_CopyToTP", "_ReduceFromTP")
# those of parallel/sequence_parallel.py's, and the ranges sp_counters puts
# around train/step.py's gradient sums
SP_FUNCTIONS = ("_AllToAll", "_GatherTokens", "_GatherTokensSum", "_sum_grads")


def fsdp_step_profile(label: str, step, batch, ms: float, card: str, tag: str = "15") -> None:
    """One profiled step: device busy ms and idle share, the NCCL kernels'
    device ms, and the host ranges of FSDP2's hooks, the tp and sp Functions,
    the gradient sums and the optimizer's step (inclusive host ms, summed
    over units), which the idle share is made of."""
    prof, wall = _profile_or_skip(lambda: step(batch), what=f"[{tag}] profiled {label} step")
    if prof is None:
        return
    host = _host_keys(prof)
    busy = nccl = 0.0
    ranges: dict = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.key not in host:
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            busy += us / 1e3
            nccl += us / 1e3 if "nccl" in e.key.lower() else 0.0
        elif e.device_type == torch.autograd.DeviceType.CPU and (
                e.key.startswith("FSDP::") or e.key.startswith("Optimizer.step")
                or any(f in e.key for f in TP_FUNCTIONS + SP_FUNCTIONS)):
            name = e.key.split(" (")[0].split(" for ")[0]  # summed over the units
            t, n = ranges.get(name, (0.0, 0))
            ranges[name] = (t + e.cpu_time_total / 1e3, n + e.count)
    print(f"[{tag}] profiled {label} step: device busy {busy:.2f} ms (NCCL kernels {nccl:.2f} ms); "
          f"idle share {max(0.0, 1 - busy / ms):.3f} of the unprofiled step ({ms:.2f} ms), "
          f"{max(0.0, 1 - busy / wall):.3f} of the profiled one ({wall:.2f} ms) [{card}]")
    for name, (t, n) in sorted(ranges.items(), key=lambda kv: -kv[1][0]):
        print(f"[{tag}]   host {t:9.3f} ms {n:4d}x {name}")


def fsdp_b16_phase(dev, card: str, bk, bb, ta) -> None:
    """Phase 15, B/16 (module notes)."""
    import tempfile

    from tvts_torch.models.factory import build_model
    from tvts_torch.parallel.partition import full_state_dict
    from tvts_torch.train.optim import make_optimizer
    from tvts_torch.train.step import make_eval_step, make_train_step
    from tvts_torch.utils.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    arch = "TVTSv2_B_16"
    train = build_train(arch, dev, noise_seed=11, text_tune_layers=3, tag="15")
    cfg, model, ocfg = train["cfg"], train["model"], train["ocfg"]
    L, TL = cfg.vision.layers, cfg.text.layers
    best = kernel_apply(train, "15")
    batches = [train_batch(cfg, FSDP_B, seed=150 + i, device=dev) for i in range(FSDP_STEPS)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with one_rank_mesh(dev) as mesh:
        sharded = sharded_copy(model, mesh)
        print(f"[15] {arch} sharded by fsdp_shard on a 1-rank {mesh.backend} group (dp "
              f"{mesh.dp} x fsdp {mesh.fsdp}): {len(model.fsdp_units())} block units and the "
              f"root; B={FSDP_B}, the optimizer built after sharding")
        plain = make_train_step(model, train["optimizer"], ocfg, apply_fn=best)
        step = make_train_step(sharded, make_optimizer(sharded, ocfg), ocfg, apply_fn=best,
                               mesh=mesh)
        for i, batch in enumerate(batches):
            reset_launch_counts(bk, bb, ta)
            aux = step(batch)
            torch.cuda.synchronize()
            launches = launch_counts(bk, bb, ta)
            expect_launches(f"sharded step {i}", launches, step_launches(L, TL, 9))
            want = plain(batch)
            print(f"[15] step {i}: sharded " + ", ".join(f"{k} {v.item():.6f}"
                                                         for k, v in aux.items())
                  + f"; {sum(launches.values())} launches (phase 7's: "
                  f"{sum(step_launches(L, TL, 9).values())}); every aux bit for bit the "
                  f"unsharded step's: {all(torch.equal(aux[k], want[k]) for k in aux)}")
        after = full_state_dict(sharded)
        diffs = {n: (after[n] - p.detach()).abs().max().item() for n, p in model.named_parameters()}
        same = all(torch.equal(after[n], p.detach()) for n, p in model.named_parameters())
        worst = max(diffs, key=diffs.get)
        print(f"[15] after {FSDP_STEPS} steps every one of {len(diffs)} parameters bit for bit "
              f"the unsharded model's: {same}; max|diff| {diffs[worst]:.3e} ({worst})")
        if not same:
            band = {n: 2e-5 * (p.detach() - before[n]).abs().max().item()
                    for n, p in model.named_parameters()}
            over = [n for n, d in diffs.items() if d > band[n]]
            if over:
                raise AssertionError(f"sharded parameters beyond 2e-5 of their largest update: "
                                     f"{over[:5]}")
        times = []
        for label, s in (("unsharded", plain), ("sharded", step), ("sharded", step),
                         ("unsharded", plain)):
            ms, mem = step_timing(s, batches[0])
            times.append((label, ms, mem))
            print(f"[15] B/16 step B={FSDP_B} {label:9s}: {ms:.2f} ms, peak memory {mem:.2f} GiB "
                  f"[{card}]")
        for label, s in (("unsharded", plain), ("sharded", step)):
            fsdp_step_profile(label, s, batches[0], min(ms for name, ms, _ in times
                                                          if name == label), card)
        with tempfile.TemporaryDirectory(prefix="tvts_fsdp_") as root:
            ckpt = CheckpointManager(root, arch=arch)
            t0 = time.perf_counter()
            ckpt.save_epoch(1, {"model": sharded, "optimizer": step.optimizer,
                                "step": step.count})
            seconds = time.perf_counter() - t0
            path = ckpt.path("checkpoint-epoch1")
            saved = torch.load(path, map_location="cpu", weights_only=True)
            layout = sorted(saved["optimizer"]["state"]) == sorted(
                plain.optimizer.state_dict()["state"]) and all(
                v.shape == model.state_dict()[k.removeprefix("module.")].shape
                for k, v in saved["state_dict"].items())
            _, loaded = build_model(arch, load_checkpoint=path, eval_mode=False, device=dev,
                                    compute_dtype=torch.bfloat16)
            got = make_eval_step(loaded, apply_fn=best)(batches[0])
            want = make_eval_step(sharded, apply_fn=best)(batches[0])
            reload = all(torch.equal(got[k], want[k]) for k in want)
            print(f"[15] checkpoint gathered from the shards: {os.path.getsize(path) / 2 ** 30:.3f} "
                  f"GiB in {seconds:.2f} s [{card}]; the unsharded layout (full tensors, the "
                  f"optimizer's int-keyed state): {layout}; build_model(strict) on it gives a "
                  f"batch's embeddings, sort accuracy and loss bit for bit the sharded model's: "
                  f"{reload}")
            if not (layout and reload):
                raise AssertionError("the checkpoint gathered from the shards does not reload")
            del loaded, saved
        del sharded, step
    del train, model, plain, before
    torch.cuda.empty_cache()
    print(f"[15] B/16 phase {time.perf_counter() - t_phase:.1f} s")


def fsdp_h14_gates(dev, train: dict, batch: dict, modes: dict, want: dict, bk, bb, ta) -> None:
    """Phase 15, H/14 (module notes): each kernel mode's forward and backward
    on a sharded copy of phase 8's model, through the step-0 gate against
    the eager unsharded model; the sharded loss equal to the unsharded
    kernel path's."""
    from tvts_torch.train.step import make_loss_fn

    t_phase = time.perf_counter()
    model = train["model"]
    loss_e, ge = grads_of(model, make_loss_fn(), batch)
    with one_rank_mesh(dev) as mesh:
        sharded = sharded_copy(model, mesh)
        for label, apply_fn in modes.items():
            loss_u = make_loss_fn(apply_fn=apply_fn)(model, batch)[0].item()
            reset_launch_counts(bk, bb, ta)
            loss_s, gs = grads_of(sharded, make_loss_fn(apply_fn=apply_fn), batch)
            torch.cuda.synchronize()
            expect_launches(f"H/14 sharded, {label}", launch_counts(bk, bb, ta), want[label])
            gate_check("15", f"H/14 sharded, {label}", loss_s, gs, loss_e, ge)
            print(f"[15] H/14 {label}, sharded: {sum(want[label].values())} launches (phase 8's); "
                  f"loss {loss_s!r}, the unsharded kernel path's {loss_u!r}: equal "
                  f"{loss_s == loss_u}")
            if loss_s != loss_u:
                raise AssertionError(f"H/14 {label}: the sharded loss differs from the unsharded")
            del gs
        del sharded
    del ge
    torch.cuda.empty_cache()
    print(f"[15] H/14 gates {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: tensor parallelism (parallel/tensor_parallel.py) through the
# kernel steps, on a 1-rank NCCL group with the tp code path forced
# ---------------------------------------------------------------------------
def tp_copy(model, mesh, fsdp: bool = False):
    """A copy of `model` cut into tp slices over the mesh's tp group (every
    attention and MLP of both towers and the sort head; at any group size,
    1 included), and with `fsdp` then sharded as phase 15 shards."""
    import copy

    from tvts_torch.parallel.partition import fsdp_shard
    from tvts_torch.parallel.tensor_parallel import tp_shard

    out = tp_shard(copy.deepcopy(model), mesh)
    return fsdp_shard(out, mesh) if fsdp else out


def tp_b16_phase(dev, card: str, bk, bb, ta) -> None:
    """Phase 16, B/16 (module notes)."""
    import tempfile

    from tvts_torch.models.factory import build_model
    from tvts_torch.parallel import tensor_parallel as tp
    from tvts_torch.parallel.partition import full_state_dict
    from tvts_torch.train.optim import make_optimizer
    from tvts_torch.train.step import make_eval_step, make_train_step
    from tvts_torch.utils.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    arch = "TVTSv2_B_16"
    train = build_train(arch, dev, noise_seed=11, text_tune_layers=3, tag="16")
    cfg, model, ocfg = train["cfg"], train["model"], train["ocfg"]
    L, TL = cfg.vision.layers, cfg.text.layers
    best = kernel_apply(train, "16")
    batches = [train_batch(cfg, FSDP_B, seed=160 + i, device=dev) for i in range(FSDP_STEPS)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with one_rank_mesh(dev) as mesh:
        copies = {"tp": tp_copy(model, mesh), "tp x fsdp": tp_copy(model, mesh, fsdp=True)}
        n_mods = len(tp.sharded_modules(copies["tp"]))
        print(f"[16] {arch} cut by tp_shard on a 1-rank {mesh.backend} group (mesh dp "
              f"{mesh.dp} x fsdp {mesh.fsdp} x sp {mesh.sp} x tp {mesh.tp}, the tp code path "
              f"forced): {n_mods} attention and MLP modules, "
              f"{len(tp.layouts(copies['tp']))} tensors in tp slices; B={FSDP_B}, each "
              f"optimizer built after sharding")
        plain = make_train_step(model, train["optimizer"], ocfg, apply_fn=best)
        steps = {label: make_train_step(m, make_optimizer(m, ocfg), ocfg, apply_fn=best,
                                        mesh=mesh) for label, m in copies.items()}
        want_launches = step_launches(L, TL, 9)
        for i, batch in enumerate(batches):
            auxes = {}
            for label, step in steps.items():
                reset_launch_counts(bk, bb, ta)
                auxes[label] = step(batch)
                torch.cuda.synchronize()
                expect_launches(f"{label} step {i}", launch_counts(bk, bb, ta), want_launches)
            want = plain(batch)
            for label, aux in auxes.items():
                print(f"[16] step {i}: {label} " + ", ".join(f"{k} {v.item():.6f}"
                                                            for k, v in aux.items())
                      + f"; {sum(want_launches.values())} launches (phase 7's); every aux "
                      f"bit for bit the unsharded step's: "
                      f"{all(torch.equal(aux[k], want[k]) for k in aux)}")
        for label, m in copies.items():
            after = full_state_dict(m)
            diffs = {n: (after[n] - p.detach()).abs().max().item()
                     for n, p in model.named_parameters()}
            same = all(torch.equal(after[n], p.detach()) for n, p in model.named_parameters())
            worst = max(diffs, key=diffs.get)
            print(f"[16] {label}: after {FSDP_STEPS} steps every one of {len(diffs)} parameters "
                  f"bit for bit the unsharded model's: {same}; max|diff| {diffs[worst]:.3e} "
                  f"({worst})")
            if not same:
                band = {n: 2e-5 * (p.detach() - before[n]).abs().max().item()
                        for n, p in model.named_parameters()}
                over = [n for n, d in diffs.items() if d > band[n]]
                if over:
                    raise AssertionError(f"{label} parameters beyond 2e-5 of their largest "
                                         f"update: {over[:5]}")
        times = {}
        for label in ("unsharded", "tp", "tp x fsdp", "tp x fsdp", "tp", "unsharded"):
            ms, mem = step_timing(steps.get(label, plain), batches[0])
            times[label] = min(times.get(label, ms), ms)
            print(f"[16] B/16 step B={FSDP_B} {label:9s}: {ms:.2f} ms, peak memory {mem:.2f} "
                  f"GiB [{card}]")
        for label, step in steps.items():
            fsdp_step_profile(label, step, batches[0], times[label], card, tag="16")
        with tempfile.TemporaryDirectory(prefix="tvts_tp_") as root:
            ckpt = CheckpointManager(root, arch=arch)
            t0 = time.perf_counter()
            ckpt.save_epoch(1, {"model": copies["tp"], "optimizer": steps["tp"].optimizer,
                                "step": steps["tp"].count})
            seconds = time.perf_counter() - t0
            path = ckpt.path("checkpoint-epoch1")
            saved = torch.load(path, map_location="cpu", weights_only=True)
            layout = sorted(saved["optimizer"]["state"]) == sorted(
                plain.optimizer.state_dict()["state"]) and all(
                v.shape == model.state_dict()[k.removeprefix("module.")].shape
                for k, v in saved["state_dict"].items())
            _, loaded = build_model(arch, load_checkpoint=path, eval_mode=False, device=dev,
                                    compute_dtype=torch.bfloat16)
            got = make_eval_step(loaded, apply_fn=best)(batches[0])
            want = make_eval_step(copies["tp"], apply_fn=best)(batches[0])
            reload = all(torch.equal(got[k], want[k]) for k in want)
            print(f"[16] checkpoint gathered from the tp slices: "
                  f"{os.path.getsize(path) / 2 ** 30:.3f} GiB in {seconds:.2f} s [{card}]; the "
                  f"reference layout (full tensors, the optimizer's int-keyed state): {layout}; "
                  f"build_model(strict) on it gives a batch's embeddings, sort accuracy and "
                  f"loss bit for bit the tp copy's: {reload}")
            if not (layout and reload):
                raise AssertionError("the checkpoint gathered from the tp slices does not reload")
            del loaded, saved
        del copies, steps
    del train, model, plain, before
    torch.cuda.empty_cache()
    print(f"[16] B/16 phase {time.perf_counter() - t_phase:.1f} s")


def tp_h14_gates(dev, train: dict, batch: dict, modes: dict, want: dict, bk, bb, ta) -> None:
    """Phase 16, H/14 (module notes): each kernel mode's forward and backward
    on a tp copy of phase 8's model, through the step-0 gate against the
    eager unsharded model. Where every sharded module runs inside the
    kernel path's gathered window (the sort head on H7), the tp copy's loss
    equals the unsharded kernel path's; the preset's eager sort head takes
    Megatron's row products, whose bias is added after the sum over tp (a
    bf16 rounding apart from one F.linear), as the JAX preset's sort head
    runs partitioned under GSPMD, and is held to the gate alone."""
    from tvts_torch.train.step import make_loss_fn

    t_phase = time.perf_counter()
    model = train["model"]
    loss_e, ge = grads_of(model, make_loss_fn(), batch)
    with one_rank_mesh(dev) as mesh:
        copy = tp_copy(model, mesh)
        for label, apply_fn in modes.items():
            loss_u = make_loss_fn(apply_fn=apply_fn)(model, batch)[0].item()
            reset_launch_counts(bk, bb, ta)
            loss_t, gt = grads_of(copy, make_loss_fn(apply_fn=apply_fn), batch)
            torch.cuda.synchronize()
            expect_launches(f"H/14 tp, {label}", launch_counts(bk, bb, ta), want[label])
            gate_check("16", f"H/14 tp, {label}", loss_t, gt, loss_e, ge)
            exact = apply_fn.keywords.get("sort_kernel", True)
            print(f"[16] H/14 {label}, tp copy: {sum(want[label].values())} launches (phase 8's); "
                  f"loss {loss_t!r}, the unsharded kernel path's {loss_u!r}: equal "
                  f"{loss_t == loss_u}, |diff| {abs(loss_t - loss_u):.3e}"
                  + ("" if exact else " (the eager sort head's row products: the gate holds it)"))
            if exact and loss_t != loss_u:
                raise AssertionError(f"H/14 {label}: the tp copy's loss differs from the "
                                     f"unsharded")
            del gt
        del copy
    del ge
    torch.cuda.empty_cache()
    print(f"[16] H/14 gates {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 17: sequence parallelism (parallel/sequence_parallel.py) through the
# eager step, the kernel step and the H9 tower, on a 1-rank NCCL group with
# the sp code path forced
# ---------------------------------------------------------------------------
def sp_counters(mesh):
    """Count the forward calls of parallel/sequence_parallel.py's Functions
    and the gradient sums of train/step.py (`_sum_grads[sp]` over the mesh's
    sp group, `_sum_grads[data]` over its data group), each sum inside a
    profiler range of that name. Returns (the counts, a function that
    removes the wrappers)."""
    from tvts_torch.parallel import sequence_parallel as sp
    from tvts_torch.train import step as step_mod

    counts: dict = {}
    classes = [getattr(sp, name) for name in SP_FUNCTIONS[:3]]
    applies = [cls.apply for cls in classes]  # each bound to its class, before any is wrapped
    for cls, apply in zip(classes, applies):
        def counting(*args, _apply=apply, _name=cls.__name__):
            counts[_name] = counts.get(_name, 0) + 1
            return _apply(*args)
        cls.apply = counting
    sum_grads = step_mod._sum_grads

    def summing(params, group, divisor=1):
        name = "_sum_grads[sp]" if group is mesh.sp_group else "_sum_grads[data]"
        counts[name] = counts.get(name, 0) + 1
        with torch.profiler.record_function(name):
            return sum_grads(params, group, divisor)

    step_mod._sum_grads = summing

    def restore():
        for cls in classes:
            del cls.apply  # the inherited autograd.Function.apply again
        step_mod._sum_grads = sum_grads

    return counts, restore


def parted(model):
    """A copy of `model` whose video tower carries the JAX token_partition."""
    import copy

    from tvts_torch.parallel.sequence_parallel import TOKEN_PARTITION

    out = copy.deepcopy(model)
    (out.video_model if hasattr(out, "video_model") else out).token_partition = TOKEN_PARTITION
    return out


def sp_tower_check(dev, model, batch, mesh, counts, bk, bb, ta) -> None:
    """The eager tower with use_pallas=True (H9's space core in every block)
    under sp against the same tower without it, at the extraction shape (no
    tube mask, N = 196), in bf16 and in f32: one launch a block, the pooled
    embedding and the tokens bit for bit."""
    import copy

    name = "divided_space_time_attention_fused"
    L = model.cfg.vision.layers
    tower = copy.deepcopy(model.video_model)
    tower.use_pallas = True
    for label, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        tower.compute_dtype = dtype
        sp_tower = parted(tower)
        outs, launches = {}, {}
        for what, m in (("whole", tower), ("sp", sp_tower)):
            counts.clear()
            reset_launch_counts(bk, bb, ta)
            with torch.no_grad(), no_tf32():
                outs[what] = m(batch["video"])
            torch.cuda.synchronize()
            launches[what] = launch_counts(bk, bb, ta)
            expect_launches(f"use_pallas tower, {what} ({label})", launches[what],
                            {name: L, f"{name} (f32)": L * (dtype is None)})
        if counts != {"_AllToAll": 4 * L, "_GatherTokens": 1}:
            raise AssertionError(f"the sp tower ({label}) ran {counts}")
        same = all(torch.equal(a, b) for a, b in zip(outs["whole"], outs["sp"]))
        print(f"[17] eager tower use_pallas=True under sp ({label}, B={len(batch['video'])}, "
              f"N={model.cfg.vision.patches_per_frame}): {launches['sp'][name]} H9 space launches "
              f"a forward (without sp: {launches['whole'][name]}); sp Functions {counts}; pooled "
              f"and tokens bit for bit the tower without sp: {same}")
        if not same:
            raise AssertionError(f"the use_pallas tower under sp ({label}) differs from the tower "
                                 "without it")
    del tower, sp_tower, outs


def sp_b16_phase(dev, card: str, bk, bb, ta) -> None:
    """Phase 17, B/16 (module notes)."""
    from tvts_torch.train.optim import make_optimizer
    from tvts_torch.train.step import make_train_step

    t_phase = time.perf_counter()
    arch = "TVTSv2_B_16"
    train = build_train(arch, dev, noise_seed=11, text_tune_layers=3, tag="17")
    cfg, model, ocfg = train["cfg"], train["model"], train["ocfg"]
    v, L, TL = cfg.vision, cfg.vision.layers, cfg.text.layers
    best = kernel_apply(train, "17")
    batches = [train_batch(cfg, FSDP_B, seed=170 + i, device=dev) for i in range(FSDP_STEPS)]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with one_rank_mesh(dev) as mesh:
        counts, restore = sp_counters(mesh)
        try:
            import copy

            models = {"eager": model, "eager sp": parted(model),
                      "kernels": copy.deepcopy(model), "kernels sp": parted(model)}
            steps = {label: make_train_step(m, train["optimizer"] if label == "eager" else
                                            make_optimizer(m, ocfg), ocfg,
                                            apply_fn=best if label.startswith("kernels") else None,
                                            mesh=mesh if label.endswith("sp") else None)
                     for label, m in models.items()}
            S = 1 + v.num_frames * v.n_keep
            print(f"[17] {arch} with token_partition on a 1-rank {mesh.backend} group (mesh dp "
                  f"{mesh.dp} x fsdp {mesh.fsdp} x sp {mesh.sp} x tp {mesh.tp}, the sp code path "
                  f"forced): S = {S} tokens, {S} a rank ({-S % mesh.sp} pad rows at sp "
                  f"{mesh.sp}); {len(models['eager sp'].sp_parameters())} of "
                  f"{len(list(model.parameters()))} tensors summed over sp; B={FSDP_B}, eager "
                  f"and \"best\" kernel steps, each sp copy's optimizer its own")
            want = {"eager": {}, "eager sp": {"_AllToAll": 4 * L, "_GatherTokens": 1,
                                              "_sum_grads[data]": 1, "_sum_grads[sp]": 1},
                    "kernels": {}, "kernels sp": {"_sum_grads[data]": 1}}
            want_launches = step_launches(L, TL, 9)
            for i, batch in enumerate(batches):
                auxes = {}
                for label, step in steps.items():
                    counts.clear()
                    reset_launch_counts(bk, bb, ta)
                    auxes[label] = step(batch)
                    torch.cuda.synchronize()
                    expect_launches(f"{label} step {i}", launch_counts(bk, bb, ta),
                                    want_launches if label.startswith("kernels") else {})
                    if counts != want[label]:
                        raise AssertionError(f"{label} step {i}: sp calls {counts}, expected "
                                             f"{want[label]}")
                for label in ("eager", "kernels"):
                    a, b = auxes[f"{label} sp"], auxes[label]
                    print(f"[17] step {i}: {label} sp " + ", ".join(
                        f"{k} {x.item():.6f}" for k, x in a.items())
                        + f"; {sum(want_launches.values()) if label == 'kernels' else 0} launches; "
                        f"sp calls {want[label + ' sp']}; every aux bit for bit the step without "
                        f"sp: {all(torch.equal(a[k], b[k]) for k in a)}")
            for label in ("eager", "kernels"):
                ref, got = models[label], models[f"{label} sp"]
                diffs = {n: (q.detach() - p.detach()).abs().max().item()
                         for (n, p), q in zip(ref.named_parameters(), got.parameters())}
                same = all(torch.equal(q.detach(), p.detach())
                           for p, q in zip(ref.parameters(), got.parameters()))
                worst = max(diffs, key=diffs.get)
                print(f"[17] {label} sp: after {FSDP_STEPS} steps every one of {len(diffs)} "
                      f"parameters bit for bit the step without sp: {same}; max|diff| "
                      f"{diffs[worst]:.3e} ({worst})")
                if not same:
                    band = {n: 2e-5 * (p.detach() - before[n]).abs().max().item()
                            for n, p in ref.named_parameters()}
                    over = [n for n, d in diffs.items() if d > band[n]]
                    if over:
                        raise AssertionError(f"{label} sp parameters beyond 2e-5 of their "
                                             f"largest update: {over[:5]}")
            sp_tower_check(dev, model, batches[0], mesh, counts, bk, bb, ta)
            times = {}
            for label in ("eager", "eager sp", "eager sp", "eager"):
                ms, mem = step_timing(steps[label], batches[0])
                times[label] = min(times.get(label, ms), ms)
                print(f"[17] B/16 eager step B={FSDP_B} {label:8s}: {ms:.2f} ms, peak memory "
                      f"{mem:.2f} GiB [{card}]")
            for label in ("eager", "eager sp"):
                fsdp_step_profile(label, steps[label], batches[0], times[label], card, tag="17")
            del models, steps
        finally:
            restore()
    del train, model, before
    torch.cuda.empty_cache()
    print(f"[17] B/16 phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 18: the Frozen-style encoder and the ImageNet-style train transforms
# (downstream/video_transformer.py, downstream/video_transforms.py)
# ---------------------------------------------------------------------------
FROZEN_B, FROZEN_RATE_B = 4, 8
FROZEN_CLIP = (16, 25, (256, 340))  # frames, fps, (h, w) of the cv2-written clip
FROZEN_AUGMENT = "rand-m7-n4-mstd0.5-inc1"  # ft_ssv2.sh's --aa
FROZEN_COS = 0.995  # bf16 logits against f32 (PERF.md §2's v1 band)


def frozen_phase(dev, card: str, bk, bb, ta, root: str) -> None:
    """Phase 18 (module notes)."""
    import cv2

    from tvts_torch.downstream.video_transformer import SpaceTimeTransformer
    from tvts_torch.downstream.video_transforms import transforms_imagenet_train

    t_phase = time.perf_counter()
    model = SpaceTimeTransformer()  # the published defaults: 224, 16, 768 x 12, 12 heads, 16 frames
    model.reset_parameters(torch.Generator().manual_seed(18))
    add_noise_(model, 18, torch.device("cpu"))  # the zero-init time attention made real
    model = model.to(dev).eval()
    T, n = model.num_frames, (224 // model.patch_size) ** 2
    print(f"[18] SpaceTimeTransformer (Frozen-style): 224^2, patch {model.patch_size}, "
          f"{model.cls_token.shape[-1]} x {len(model.blocks)}, {model.blocks[0].attn.num_heads} "
          f"heads, {T} frames, S = {1 + T * n}, {model.num_classes} classes, "
          f"{sum(p.numel() for p in model.parameters())} f32 parameters with seeded noise")
    gen = torch.Generator(device=dev).manual_seed(18)
    video = torch.randn(FROZEN_RATE_B, 3, T, 224, 224, generator=gen, device=dev)
    logits = {}
    reset_launch_counts(bk, bb, ta)
    for label, dtype in (("bf16", torch.bfloat16), ("f32", None)):
        model.set_compute_dtype(dtype)
        with torch.no_grad(), no_tf32():
            logits[label] = model(video[:FROZEN_B]).float().cpu().numpy()
    model.set_compute_dtype(torch.bfloat16)
    launched = {k: c for k, c in launch_counts(bk, bb, ta).items() if c}
    cos = cos_rows(logits["bf16"], logits["f32"]).min()
    ok = all(np.isfinite(x).all() and x.shape == (FROZEN_B, model.num_classes)
             for x in logits.values())
    print(f"[18] B={FROZEN_B} logits, bf16 compute over f32 weights against f32: min cosine "
          f"{cos:.6f} (>= {FROZEN_COS}), max|diff| "
          f"{np.abs(logits['bf16'] - logits['f32']).max():.3e}; hand-written kernel launches "
          f"{launched} (the encoder reaches none)")
    if not ok or cos < FROZEN_COS or launched:
        raise AssertionError("the Frozen encoder's bf16 forward disagrees with f32")
    with torch.no_grad():
        ms = cuda_ms(lambda: model(video), iters=5)
        torch.cuda.reset_peak_memory_stats()
        model(video)
        torch.cuda.synchronize()
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[18] Frozen forward B={FROZEN_RATE_B} (bf16): {ms:.2f} ms, "
          f"{FROZEN_RATE_B / ms * 1e3:.2f} clips/s, peak memory {mem:.2f} GiB [{card}]")
    # the train transforms over a cv2-written clip, into the encoder
    n_frames, fps, shape = FROZEN_CLIP
    path = os.path.join(root, "frozen", "clip.mp4")
    write_clip(path, 18, n_frames, fps, shape)
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame[..., ::-1])
    cap.release()
    clip = np.ascontiguousarray(np.stack(frames))
    pipe = transforms_imagenet_train(img_size=224, auto_augment=FROZEN_AUGMENT, re_prob=0.25,
                                     re_mode="pixel", rng=np.random.default_rng(18))
    out = pipe(clip)
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = pipe(clip)
    host_ms = (time.perf_counter() - t0) / reps * 1e3
    x = torch.from_numpy(out).to(dev).permute(1, 0, 2, 3)[None]  # [1, C, T, H, W]
    with torch.no_grad():
        y = model(x).float()
    print(f"[18] transforms_imagenet_train({FROZEN_AUGMENT!r}, erasing 0.25 pixel) on a "
          f"cv2-written {clip.shape[0]}-frame {shape[1]}x{shape[0]} clip -> {tuple(out.shape)} "
          f"{out.dtype}: {host_ms:.2f} ms of host a clip; the encoder's logits on it "
          f"{tuple(y.shape)}, finite {bool(torch.isfinite(y).all())} [{card}]")
    if out.shape != (n_frames, 3, 224, 224) or not np.isfinite(out).all() \
            or not torch.isfinite(y).all():
        raise AssertionError("the train transforms or the encoder on them are not finite")
    del model, video
    torch.cuda.empty_cache()
    print(f"[18] phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 13: the TVTS v1 family on the card (DistilBERT, the joint ViT, the
# v1 sort head), through tvts_torch.cli.train_dist_TVTS
# ---------------------------------------------------------------------------
V1_CONFIG, V1_CC_CONFIG = "v1-dist-yt-pt.json", "v1-dist-cc-web-pt.json"
V1_COS = 0.995  # bf16 embeddings against f32 at step 0 (PERF.md §2's f32 band)
V1_DLOSS = 2e-2  # |loss_bf16 - loss_f32| at step 0
V1_B = 16  # the config's batch
V1_STEPS = 12  # optimizer steps an epoch: the window TRAINER_WINDOW is steps 3-12
V1_RESUMED_STEPS = 4  # steps of the resumed epoch 2
V1_YTT_REPEAT = 3  # the v1 metadata lists each YT-Temporal video this many times
V1_CC_IMAGES = 96  # CC3M images (2 batches of the config's 48), half PNG, half JPEG
BERT_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]


def write_v1_vocab(path: str) -> str:
    """A WordPiece vocab.txt over the synthetic ASR's tokens: BERT's special
    tokens, every word of WORDS, punctuation and digits."""
    tokens = (BERT_SPECIALS + sorted(set(WORDS)) + list(",.?!&;#'")
              + [str(d) for d in range(10)])
    with open(path, "w") as f:
        f.write("\n".join(tokens) + "\n")
    return path


def v1_config(path: str, name: str, loaders: dict, trainer: dict) -> str:
    """The repo's tvts_tpu/configs/<name> with `loaders[dataset_name]` merged
    into the args of each loader it names (the others dropped) and `trainer`
    into its trainer section; written to path."""
    with open(REPO / "tvts_tpu" / "configs" / name) as f:
        config = json.load(f)
    config["data_loader"] = [spec for spec in config["data_loader"]
                             if spec["args"]["dataset_name"] in loaders]
    for spec in config["data_loader"]:
        spec["args"].update(loaders[spec["args"]["dataset_name"]])
    config["trainer"].update(trainer)
    with open(path, "w") as f:
        json.dump(config, f, indent=2)
    return path


def v1_batch(cfg, B: int, seed: int, dev) -> dict:
    """A synthetic v1 batch: normalised clips of num_frames, a keep set a tube
    [B, n_tubes, n_keep], num_clips clip-major id rows a clip ([CLS], ids,
    [SEP], then padding; row 0 full) with their mask, labels arange(num_clips)."""
    rng = np.random.default_rng(seed)
    n, L = cfg.num_clips, cfg.max_text_len
    video = rng.standard_normal((B, cfg.num_frames, 3, cfg.img_size, cfg.img_size))
    keep = np.stack([np.stack([rng.permutation(cfg.patches_per_frame)[:cfg.n_keep]
                               for _ in range(cfg.n_tubes)]) for _ in range(B)])
    ids = np.zeros((n * B, L), np.int64)
    mask = np.zeros((n * B, L), np.int64)
    for r in range(n * B):
        k = L if r == 0 else int(rng.integers(4, L + 1))
        ids[r, :k] = np.concatenate([[101], rng.integers(1000, cfg.text.vocab_size, k - 2),
                                     [102]])
        mask[r, :k] = 1
    return {"video": torch.tensor(video, dtype=torch.float32, device=dev),
            "text_ids": torch.from_numpy(ids).to(dev),
            "attention_mask": torch.from_numpy(mask).to(dev),
            "keep_ind": torch.from_numpy(keep).to(dev),
            "labels": torch.from_numpy(np.tile(np.arange(n), (B, 1))).to(dev)}


def v1_forward_check(dev, card: str, cfg) -> tuple:
    """The full-width v1 model (seeded weights, noise on every leaf) at B=16:
    the bf16 forward against f32 at step 0 (the gates) and the worst
    gradient error. Returns (bf16 model, batch)."""
    import copy

    from tvts_torch.models.factory import build_v1_model
    from tvts_torch.train.step import default_apply, make_loss_fn

    model = build_v1_model(cfg, device=dev, seed=0, compute_dtype=torch.bfloat16)
    add_noise_(model, 31, dev)
    model32 = copy.deepcopy(model)
    model32.set_compute_dtype(None)
    n_params = sum(p.numel() for p in model.parameters())
    batch = v1_batch(cfg, V1_B, seed=13, dev=dev)
    loss_fn = make_loss_fn()
    out, loss, grads = {}, {}, {}
    for label, m in (("f32", model32), ("bf16", model)):
        with no_tf32():
            with torch.no_grad():
                out[label] = [t.float().cpu().numpy() for t in default_apply(m, batch)]
            loss[label], grads[label] = grads_of(m, loss_fn, batch)
    del model32
    torch.cuda.empty_cache()
    shapes = [o.shape for o in out["bf16"]]
    want = [(V1_B, cfg.projection_dim), (V1_B, cfg.projection_dim),
            (V1_B, cfg.num_clips, cfg.num_clips)]
    if shapes != want or not all(np.isfinite(o).all() for o in out["bf16"]):
        raise AssertionError(f"v1 forward: shapes {shapes} (expected {want}) or non-finite")
    cos_t = cos_rows(out["bf16"][0], out["f32"][0]).min()
    cos_v = cos_rows(out["bf16"][1], out["f32"][1]).min()
    dloss = abs(loss["bf16"] - loss["f32"])
    # tools/train_grad_check.py's measure: over tensors with max|g| > 1e-2 *
    # the global max (a k bias's gradient is zero but for rounding)
    top = max(g.abs().max().item() for g in grads["f32"].values())
    errs = {n: ((grads["bf16"][n] - g).abs().max() / g.abs().max()).item()
            for n, g in grads["f32"].items() if g.abs().max() > 1e-2 * top}
    worst = max(errs, key=errs.get)
    print(f"[13] TVTSv1 {n_params / 1e6:.2f} M parameters (video {cfg.depth} x "
          f"{cfg.embed_dim}, {cfg.n_tubes} tubes x {cfg.n_keep} kept, S = "
          f"{1 + cfg.n_tubes * cfg.n_keep}; DistilBERT {cfg.text.n_layers} x {cfg.text.dim}, "
          f"vocab {cfg.text.vocab_size}, {cfg.max_text_len} tokens; sort head S = "
          f"{1 + cfg.n_tubes * cfg.n_keep + cfg.num_clips}), forward B={V1_B} bf16 against "
          f"f32: text cosine min {cos_t:.6f}, video cosine min {cos_v:.6f} (>= {V1_COS}); "
          f"loss {loss['bf16']:.6f} / {loss['f32']:.6f}, |dloss| {dloss:.2e} (< {V1_DLOSS}); "
          f"worst relative gradient error (max|dg| / max|g|, {len(errs)} of {len(grads['f32'])} "
          f"tensors with max|g| > 1e-2 * {top:.3e}) {errs[worst]:.4f} at {worst}")
    if min(cos_t, cos_v) < V1_COS or dloss >= V1_DLOSS:
        raise AssertionError("the v1 bf16 forward disagrees with f32")
    return model, batch


def v1_resident(dev, card: str, cfg, model, batch, bk, bb, ta) -> dict:
    """The forward and the step at B=16 on the device-resident batch: ms,
    clips/s, peak memory, and one profiled step's breakdown."""
    from tvts_torch.train.optim import OptimizerConfig, make_v1_optimizer
    from tvts_torch.train.step import default_apply, make_train_step

    with torch.inference_mode():
        fwd_ms = cuda_ms(lambda: default_apply(model, batch), iters=5)
    step = make_train_step(model, make_v1_optimizer(model), OptimizerConfig())
    reset_launch_counts(bk, bb, ta)
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0, iters = time.perf_counter(), 5
    for _ in range(iters):
        step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / iters * 1e3
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    expect_launches("v1 steps", launch_counts(bk, bb, ta), {})
    print(f"[13] TVTSv1 B={V1_B} device-resident: forward {fwd_ms:.2f} ms "
          f"({V1_B / fwd_ms * 1e3:.2f} clips/s); step {ms:.2f} ms, {V1_B / ms * 1e3:.2f} "
          f"clips/s, peak memory {mem:.2f} GiB; no hand-written kernel launched [{card}]")
    eager_step_profile("13", f"TVTSv1 step B={V1_B}", lambda: step(batch), ms, card)
    return {"fwd_ms": fwd_ms, "ms": ms, "clips_s": V1_B / ms * 1e3, "mem": mem}


def eager_step_profile(tag: str, what: str, fn, ms: float, card: str) -> float | None:
    """One profiled call of an eager step: device busy ms, idle share against
    the unprofiled step (`ms`) and the profiled one, busy time by kind and the
    top kernels. Returns the busy ms, or None where the profiler gives up."""
    rows, wall = kernel_timeline(fn, f"[{tag}] profiled {what}")
    if rows is None:
        return None
    busy = sum(us for us, _ in rows) / 1e3
    print(f"[{tag}] profiled {what}: device busy {busy:.2f} ms, {len(rows)} "
          f"kernels; idle share {max(0.0, 1 - busy / ms):.3f} of the unprofiled step "
          f"({ms:.2f} ms), {max(0.0, 1 - busy / wall):.3f} of the profiled one ({wall:.2f} ms) "
          f"[{card}]")
    groups, by_label = {}, {}
    for us, key in rows:
        group = ("optimizer (multi_tensor_apply)" if "multi_tensor_apply" in key
                 else "convolution (the Conv3d patchify, cuDNN)"
                 if any(k in key for k in ("convolve", "wgrad_alg", "dgrad_alg"))
                 else "GEMM (cuBLAS / CUTLASS)"
                 if any(k in key for k in ("nvjet", "gemm", "cutlass", "sm90_xmma"))
                 else "softmax" if "softmax" in key.lower()
                 else "other (elementwise, reductions, copies, LayerNorm in torch ops)")
        groups[group] = groups.get(group, 0.0) + us / 1e3
        t, n = by_label.get(key, (0.0, 0))
        by_label[key] = (t + us / 1e3, n + 1)
    for group, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}]   {t:9.3f} ms ({t / busy:.3f}) {group}")
    print(f"[{tag}]   top device time by kernel:")
    for key, (t, n) in sorted(by_label.items(), key=lambda kv: -kv[1][0])[:16]:
        print(f"[{tag}]   {t:9.3f} ms {n:5d}x {key[:100]}")
    return busy


def v1_trainer(dev, card: str, cfg, root: str, config_path: str, vocab: str,
               resident: dict, bk, bb, ta) -> None:
    """v1-dist-yt-pt.json through the CLI twin: 12 steps, the epoch file
    rebuilt strictly, then `-r` and a second epoch."""
    from tvts_torch.cli import train_dist_TVTS as cli
    from tvts_torch.models.factory import build_v1_model
    from tvts_torch.train.step import make_eval_step
    from tvts_torch.train.trainer import prepare_batch
    from tvts_torch.utils.config import read_json

    ytt = next(spec["args"] for spec in read_json(config_path)["data_loader"]
               if spec["args"]["dataset_name"] == "YTTemporal")
    meta = os.path.join(root, "meta_v1")
    os.makedirs(meta, exist_ok=True)
    with open(os.path.join(ytt["meta_root"], "yttemporal_train.csv")) as f:
        header, *names = f.read().splitlines()
    with open(os.path.join(meta, "yttemporal_train.csv"), "w") as f:
        f.write("\n".join([header] + names * V1_YTT_REPEAT) + "\n")
    results = os.path.join(root, "results_v1")
    edits = {"epochs": 1, "max_samples_per_epoch": V1_STEPS * V1_B, "save_dir": results}
    path = v1_config(os.path.join(root, "v1.json"), V1_CONFIG, {"YTTemporal": {
        "data_dir": ytt["data_dir"], "meta_root": meta, "num_workers": 8}}, edits)
    print(f"[13] {V1_CONFIG} edited in data_dir, meta_root ({len(names)} YT-Temporal videos "
          f"listed {V1_YTT_REPEAT} times), num_workers (8) and trainer {edits}; 4 clips x 4 "
          f"frames and 4 transcripts an item, per_tube_masks = {cfg.n_tubes}")
    record = {"steps": [], "waits": [], "vals": [], "saves": []}
    argv = ["-c", path, "--bert_vocab", vocab, "--num_processes", "1", "--process_id", "0"]
    try:
        with trainer_hooks(bk, bb, ta, record):
            trainer = cli.main([*argv, "--coordinator", f"localhost:{free_port()}"])
        steps = record["steps"]
        if len(steps) != V1_STEPS or trainer.train_step.count != V1_STEPS:
            raise AssertionError(f"{len(steps)} v1 Trainer steps, count "
                                 f"{trainer.train_step.count}")
        for i, (ytt_batch, launches, _) in enumerate(steps):
            expect_launches(f"v1 Trainer step {i + 1}", launches, {})
        aux = {k: torch.stack([a[k].float() for _, _, a in steps]).cpu()
               for k in ("loss", "loss_ct", "loss_ce")}
        if not all(torch.isfinite(v).all() for v in aux.values()) \
                or not (aux["loss_ce"] > 0).all() or not all(y for y, _, _ in steps):
            raise AssertionError(f"v1 Trainer steps: {aux}")
        sec = record["t1"] - record["t0"]
        wait = sum(w for i, w in record["waits"] if i in TRAINER_WINDOW)
        clips = V1_B * len(TRAINER_WINDOW)
        print(f"[13] the v1 Trainer (1-rank NCCL group, the sharded step, B={V1_B}): losses "
              f"finite, loss_ce > 0 in every step (first loss {aux['loss'][0]:.6f}, last "
              f"{aux['loss'][-1]:.6f}); over steps {TRAINER_WINDOW.start + 1}-"
              f"{TRAINER_WINDOW.stop}: {clips / sec:.2f} clips/s, {sec / len(TRAINER_WINDOW) * 1e3:.1f} "
              f"ms a step, host share {wait / sec:.3f}; device-resident {resident['clips_s']:.2f} "
              f"clips/s ({resident['ms']:.2f} ms a step) [{card}]")
        print(f"[13] seconds waiting on the feed before each step of that window: "
              + json.dumps([round(w, 4) for i, w in record["waits"] if i in TRAINER_WINDOW]))
        for name, seconds, size in record["saves"]:
            print(f"[13] saved {name}: {size / 2 ** 30:.3f} GiB in {seconds:.2f} s "
                  f"({size / 2 ** 30 / seconds:.2f} GiB/s) [{card}]")
        epoch1 = os.path.join(trainer.ckpt.save_dir, "checkpoint-epoch1.pth")
        batch = {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in prepare_batch(
            next(iter(trainer.data_loaders[0])), tokenize_fn=trainer.tokenize_fn).items()}
        want = make_eval_step(trainer.model)(batch)
        loaded = build_v1_model(trainer.model.cfg, load_checkpoint=epoch1, device=dev,
                                compute_dtype=trainer.model.video_model.compute_dtype)
        got = make_eval_step(loaded)(batch)
        same = all(torch.equal(got[k], want[k]) for k in ("video_emb", "text_emb", "sort_acc"))
        print(f"[13] build_v1_model(load_checkpoint=checkpoint-epoch1.pth), strict: embeddings "
              f"of a batch ({batch['video'].shape[0]} clips) bit for bit the trained model's: "
              f"{same}")
        if not same:
            raise AssertionError("a strict reload of the v1 epoch checkpoint disagrees")
        del trainer, loaded, want, got
        torch.cuda.empty_cache()
        record.update(steps=[], waits=[], vals=[], saves=[])
        # the resumed epoch: V1_RESUMED_STEPS steps
        path = v1_config(path, V1_CONFIG, {"YTTemporal": {
            "data_dir": ytt["data_dir"], "meta_root": meta, "num_workers": 8}},
            dict(edits, epochs=2, max_samples_per_epoch=V1_RESUMED_STEPS * V1_B))
        with trainer_hooks(bk, bb, ta, record):
            resumed = cli.main([*argv, "--coordinator", f"localhost:{free_port()}",
                                "-r", epoch1])
        res = record["resume"]
        print(f"[13] -r checkpoint-epoch1.pth: " + json.dumps(res))
        if not (res["parameters"] and res["adamw_state"] and res["next_epoch"] == 2
                and res["step"][0] == res["step"][1] == V1_STEPS):
            raise AssertionError(f"the v1 resume restored another state: {res}")
        if resumed.train_step.count != V1_STEPS + V1_RESUMED_STEPS \
                or len(record["steps"]) != V1_RESUMED_STEPS:
            raise AssertionError("the resumed v1 epoch did not run")
        print(f"[13] the resumed epoch 2 ran: {len(record['steps'])} steps, "
              f"{[name for name, _, _ in record['saves']]} written")
        del resumed
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(results, ignore_errors=True)


def v1_cc3m(card: str, root: str, vocab: str) -> None:
    """The cc-web config's CC3M loader on cv2-written PNG and JPEG images;
    the CLI twin refuses that config by name."""
    import cv2

    from tvts_torch.cli import train_dist_TVTS as cli
    from tvts_torch.utils.config import ConfigParser, read_json

    cc = os.path.join(root, "cc3m")
    os.makedirs(os.path.join(cc, "training"))
    rows = []
    for i in range(V1_CC_IMAGES):
        shape = ((240, 320), (300, 400), (320, 240), (256, 256))[i % 4]
        name = f"{i:05d}.{'png' if i % 2 else 'jpg'}"
        frame = clip_frames(3000 + i, [0], shape)[0]
        cv2.imwrite(os.path.join(cc, "training", name), np.ascontiguousarray(frame[..., ::-1]))
        rows.append(f"{synthetic_captions(1, 3000 + i)[0]}\t{name}")
    with open(os.path.join(cc, "cc3m_train.tsv"), "w") as f:
        f.write("caption\tfilename\n" + "\n".join(rows) + "\n")
    path = v1_config(os.path.join(root, "v1_cc.json"), V1_CC_CONFIG, {"ConceptualCaptions3M": {
        "data_dir": cc, "meta_root": cc, "num_workers": 8}}, {"save_dir": os.path.join(root, "r")})
    config = ConfigParser(read_json(path), test=True)
    spec = config["data_loader"][0]
    ds, loader = config.initialize_dataset_loader(spec)
    t0, items = time.perf_counter(), 0
    for batch in loader:
        n, res = loader.batch_size, spec["args"]["video_params"]["input_res"]
        want = (n, spec["args"]["video_params"]["num_frames"], 3, res, res)
        # the list-wrapped captions collate clip-major: one list of n
        if batch["video"].shape != want or batch["keep_ind"].shape != (n, 49) \
                or [len(t) for t in batch["text"]] != [n] \
                or not np.isfinite(batch["video"]).all():
            raise AssertionError(f"CC3M batch: video {batch['video'].shape} (expected {want}), "
                                 f"keep_ind {batch['keep_ind'].shape}")
        items += n
    sec = time.perf_counter() - t0
    print(f"[13] {V1_CC_CONFIG}'s CC3M loader ({type(ds).__name__}, {len(ds)} cv2-written "
          f"images, PNG and JPEG, 240x320 to 300x400): {items} items in batches of "
          f"{loader.batch_size}, video {tuple(batch['video'].shape)}, keep_ind "
          f"{tuple(batch['keep_ind'].shape)}: {items / sec:.2f} items/s, "
          f"{loader.num_workers} workers [{card}]")
    cc_path = v1_config(os.path.join(root, "v1_cc_web.json"), V1_CC_CONFIG, {
        "ConceptualCaptions3M": {"data_dir": cc, "meta_root": cc},
        "WebVid": {"data_dir": cc, "meta_root": cc}}, {"save_dir": os.path.join(root, "r")})
    try:
        cli.main(["-c", cc_path, "--bert_vocab", vocab])
    except ValueError as e:
        if "per_tube_masks" not in str(e) or "joint_vit.py:84-86" not in str(e):
            raise
        print(f"[13] the CLI twin refuses {V1_CC_CONFIG}: {e}")
    else:
        raise AssertionError(f"the CLI twin ran {V1_CC_CONFIG}")


def v1_phase(dev, card: str, bk, bb, ta, root: str, config_path: str) -> None:
    """Phase 13 (module notes): the TVTS v1 family at full width."""
    from tvts_torch.models.tvts_v1 import TVTSv1Config

    t_phase = time.perf_counter()
    cfg = TVTSv1Config()
    model, batch = v1_forward_check(dev, card, cfg)
    resident = v1_resident(dev, card, cfg, model, batch, bk, bb, ta)
    del model, batch
    torch.cuda.empty_cache()
    vocab = write_v1_vocab(os.path.join(root, "v1_vocab.txt"))
    v1_trainer(dev, card, cfg, root, config_path, vocab, resident, bk, bb, ta)
    v1_cc3m(card, root, vocab)
    print(f"[13] v1 phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: the v1 SSV2 downstream stack on the card, through
# tvts_torch.cli.run_class_finetuning
# ---------------------------------------------------------------------------
SSV2_CLASSES = 174
SSV2_SPLITS = {"train": 96, "val": 24, "test": 12}
SSV2_CLIP = (48, 12, (240, 427))  # frames, fps, (h, w): SSV2's 240-pixel-high clips


FT_B = 12  # ft_ssv2.sh's batch
FT_EVAL_TOL = 0.02  # fused eval logits against eager, both bf16: relative row error
FT_ARCH = {"num_classes": SSV2_CLASSES, "num_frames": 16, "img_size": 224}  # ViT-B/16 widths
FT_COS = 0.995  # bf16 pooled features and logits against f32 at step 0 (PERF.md §2's f32 band)
FT_DLOSS = 2e-2  # |loss_bf16 - loss_f32| at step 0
FT_WINDOW = range(2, 8)  # steps 3-8 of the epoch from files (0-based)
FT_LINEAR_STEPS = 3  # the linear probe's steps: the first 36 train videos, 12 val, no test
# scripts/sh/{ft,linear,zero}_ssv2.sh's flags, one epoch
FT_FLAGS = ["--model", "vit_base_patch16_224", "--nb_classes", str(SSV2_CLASSES),
            "--batch_size", str(FT_B), "--input_size", "224", "--short_side_size", "224",
            "--num_frames", "16", "--test_num_segment", "2", "--test_num_crop", "3",
            "--epochs", "1"]
FT_RECIPES = {"finetune": ["--lr", "1e-3", "--weight_decay", "0.05", "--model_ema"],
              "linear": ["--lr", "0.1", "--weight_decay", "1e-9", "--warmup_epochs", "10"],
              "zero": []}


def ssv2_tree(root: str, splits: dict, clip: tuple = SSV2_CLIP, classes: int = SSV2_CLASSES,
              workers: int = 8, write: bool = True) -> tuple[str, dict]:
    """An SSV2-shaped classification tree under root: videos/<split>/<i>.mp4
    (clip_frames, `clip` = (frames, fps, (h, w)), cv2-written unless
    write=False) and <split>.csv rows "videos/<split>/<i>.mp4 <label>",
    min(12, classes) labels spread over `classes` in turn. Returns (root,
    the clips' specs as write_clips takes them)."""
    specs, seed = {}, 14000
    n_labels = min(12, classes)
    os.makedirs(root, exist_ok=True)
    for split, n in splits.items():
        rows = []
        for i in range(n):
            rel = f"videos/{split}/{i:05d}.mp4"
            specs[os.path.join(root, rel)] = (seed, *clip)
            rows.append(f"{rel} {(i % n_labels) * (classes // n_labels)}")
            seed += 1
        with open(os.path.join(root, f"{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    if write:
        write_clips(specs, workers)
    return root, specs


def ft_pretrain_pth(dev, path: str) -> str:
    """A seeded v1 pretraining checkpoint: TVTSv1Config() from seed 0 with
    noise on every leaf, in the reference layout (save_reference_checkpoint)."""
    from tvts_torch.models.factory import build_v1_model
    from tvts_torch.utils.convert import save_reference_checkpoint

    model = build_v1_model(device=dev, seed=0)
    add_noise_(model, 41, dev)
    save_reference_checkpoint(model, path, "TVTSv1")
    del model
    torch.cuda.empty_cache()
    return path


def ft_model(dev, card: str, pth: str):
    """FinetuneViT at ft_ssv2.sh's width from the v1 checkpoint: the
    transferred tensors bit for bit the checkpoint's, fc_norm and head at init."""
    from tvts_torch.downstream.model import FinetuneViT, load_pretrain_video_tower
    from tvts_torch.utils.convert import convert_v1_state_dict, load_reference_state_dict

    model = FinetuneViT(**FT_ARCH, remat=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()
            if k.startswith(("fc_norm.", "head."))}
    sd = load_reference_state_dict(pth)
    names = load_pretrain_video_tower(model, sd)
    ref, state = convert_v1_state_dict(sd), model.state_dict()
    same = all(torch.equal(state[n], ref[f"video_model.{n}"]) for n in names)
    kept = all(torch.equal(state[k], v) for k, v in init.items())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[14] FinetuneViT ({FT_ARCH['num_classes']} classes, {FT_ARCH['num_frames']} frames "
          f"of {FT_ARCH['img_size']}², {model.depth} x {model.embed_dim}, S = "
          f"{model.pos_table.shape[0]}, "
          f"{n_params / 1e6:.2f} M parameters) from the v1 checkpoint: {len(names)} tensors "
          f"transferred (blocks.*, patch_embed.*), bit for bit: {same}; fc_norm and head at "
          f"init: {kept}")
    if not (same and kept and set(names) == set(state) - set(init)):
        raise AssertionError("load_pretrain_video_tower moved another set of tensors")
    return model.to(dev)


def ft_step0(dev, card: str, model) -> tuple:
    """bf16 against f32 at step 0 on a B=12 batch (noise on the head too):
    the pooled features' and logits' cosine, |dloss|, the worst gradient
    error. Returns (video, targets) on the card."""
    import copy

    from tvts_torch.downstream.engine import soft_ce
    from tvts_torch.downstream.mixup import one_hot
    from tvts_torch.models.layers import linear

    gen = torch.Generator(device=dev).manual_seed(43)
    with torch.no_grad():
        model.head.weight.add_(0.02 * torch.randn(model.head.weight.shape, generator=gen,
                                                  device=dev))
    rng = np.random.default_rng(14)
    T, size = FT_ARCH["num_frames"], FT_ARCH["img_size"]
    video = torch.tensor(rng.standard_normal((FT_B, T, 3, size, size), dtype=np.float32),
                         device=dev)
    targets = torch.from_numpy(one_hot(rng.integers(0, SSV2_CLASSES, FT_B), SSV2_CLASSES,
                                       0.1)).to(dev)
    model32 = copy.deepcopy(model)
    model.set_compute_dtype(torch.bfloat16)
    feats, logits, loss, grads = {}, {}, {}, {}
    for label, m in (("f32", model32), ("bf16", model)):
        with no_tf32():
            with torch.no_grad():
                f = m.forward_features(video)
                feats[label] = f.float().cpu().numpy()
                logits[label] = linear(f, m.head.weight, m.head.bias).float().cpu().numpy()
            value = soft_ce(m(video), targets)
            value.backward()
        loss[label] = value.item()
        grads[label] = {n: p.grad.float() for n, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
    cos_f = cos_rows(feats["bf16"], feats["f32"]).min()
    cos_l = cos_rows(logits["bf16"], logits["f32"]).min()
    dloss = abs(loss["bf16"] - loss["f32"])
    top = max(g.abs().max().item() for g in grads["f32"].values())
    errs = {n: ((grads["bf16"][n] - g).abs().max() / g.abs().max()).item()
            for n, g in grads["f32"].items() if g.abs().max() > 1e-2 * top}
    worst = max(errs, key=errs.get)
    print(f"[14] step 0, bf16 against f32 (remat, B={FT_B}): pooled fc_norm cosine min "
          f"{cos_f:.6f}, logits cosine min {cos_l:.6f} (>= {FT_COS}); loss {loss['bf16']:.6f} / "
          f"{loss['f32']:.6f}, |dloss| {dloss:.2e} (< {FT_DLOSS}); worst relative gradient "
          f"error (max|dg| / max|g|, {len(errs)} of {len(grads['f32'])} tensors with max|g| > "
          f"1e-2 * {top:.3e}) {errs[worst]:.4f} at {worst}")
    del model32, grads
    torch.cuda.empty_cache()
    if min(cos_f, cos_l) < FT_COS or dloss >= FT_DLOSS or not np.isfinite(logits["bf16"]).all():
        raise AssertionError("the FinetuneViT bf16 step 0 disagrees with f32")
    return video, targets


def ft_resident(dev, card: str, model, video, targets) -> dict:
    """The finetune and linear-probe steps and the eval forward at B=12 on the
    device-resident batch (remat, as the script builds the model): ms,
    clips/s, peak memory; one profiled finetune step. The eval forward is the
    CLI's (make_cls_eval_step's `use_fused`: the blocks on the kernels), its
    logits held to the eager model(video)'s on the same batch within
    FT_EVAL_TOL (the widest relative row error), and timed beside it;
    `fused_calls` in the result counts its calls."""
    import copy

    from tvts_torch.downstream.engine import (
        make_cls_eval_step,
        make_cls_train_step,
        make_finetune_optimizer,
    )

    fused, eager = make_cls_eval_step(model, use_fused=True), make_cls_eval_step(model)
    got, want = fused(video).float(), eager(video).float()
    err = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    print(f"[14] FinetuneViT eval B={FT_B}: the fused step's logits against eager "
          f"model(video): relative row error {err:.5f} (<= {FT_EVAL_TOL})")
    if not err <= FT_EVAL_TOL:
        raise AssertionError(f"the fused eval step's logits are {err} from eager model(video)")
    eval_ms = cuda_ms(lambda: fused(video), iters=5)
    eager_ms = cuda_ms(lambda: eager(video), iters=5)
    print(f"[14] FinetuneViT eval forward B={FT_B}: fused (the CLI's) {eval_ms:.2f} ms, "
          f"{FT_B / eval_ms * 1e3:.2f} clips/s; eager model(video) {eager_ms:.2f} ms, "
          f"{FT_B / eager_ms * 1e3:.2f} clips/s [{card}]")
    out = {"eval_ms": eval_ms, "eager_eval_ms": eager_ms, "fused_calls": 1 + 2 + 5}
    probe = copy.deepcopy(model)
    for mode, m in (("finetune", model), ("linear", probe)):
        opt, _ = make_finetune_optimizer(m, 1e-3, 0.05, epochs=50, steps_per_epoch=8,
                                         linear_probe=mode == "linear")
        step = make_cls_train_step(m, opt)
        losses = [step(video, targets) for _ in range(2)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0, iters = time.perf_counter(), 5
        losses += [step(video, targets) for _ in range(iters)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / iters * 1e3
        mem = torch.cuda.max_memory_allocated() / 2 ** 30
        if not torch.isfinite(torch.stack(losses)).all():
            raise AssertionError(f"{mode} step: non-finite loss")
        print(f"[14] FinetuneViT {mode} step B={FT_B} device-resident (remat, "
              f"{sum(p.numel() for p in m.parameters() if p.requires_grad) / 1e6:.2f} M "
              f"trainable): {ms:.2f} ms, {FT_B / ms * 1e3:.2f} clips/s, peak memory "
              f"{mem:.2f} GiB [{card}]")
        out[mode] = {"ms": ms, "clips_s": FT_B / ms * 1e3, "mem": mem}
        if mode == "finetune":
            out["busy"] = eager_step_profile("14", f"FinetuneViT finetune step B={FT_B}",
                                             lambda: step(video, targets), ms, card)
    del probe
    torch.cuda.empty_cache()
    return out


def cls_item_split(ds, card: str, n: int = 8) -> None:
    """Where a training item's host time goes, one item at a time on this
    thread, as VideoClsDataset.__getitem__ runs it: decode, the resize and
    crop, RandAugment, the normalisation and erasing."""
    from tvts_torch.data import video_reader
    from tvts_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, _normalise
    from tvts_torch.downstream.randaug import RandAugment
    from tvts_torch.downstream.random_erasing import RandomErasing

    spent = np.zeros(4)
    for i in range(n):
        rng = np.random.default_rng(i)
        path = ds.samples[i][0]
        t0 = time.perf_counter()
        vlen = max(video_reader.get_video_len(path, backend=ds.reader), 1)
        frames = video_reader.read_frames_at(path, ds._segment_indices(vlen, rng),
                                             backend=ds.reader)
        t1 = time.perf_counter()
        frames = ds._spatial_crop(frames, rng)
        t2 = time.perf_counter()
        frames = RandAugment(num_ops=4, magnitude=7, rng=rng)(frames)
        t3 = time.perf_counter()
        RandomErasing(probability=0.25, rng=rng)(_normalise(frames, IMAGENET_MEAN, IMAGENET_STD))
        spent += (t1 - t0, t2 - t1, t3 - t2, time.perf_counter() - t3)
    ms = 1e3 * spent / n
    print(f"[14] host time a training item, one thread ({n} items of {ds.num_frames} frames "
          f"from {SSV2_CLIP[2][1]}x{SSV2_CLIP[2][0]} clips): decode {ms[0]:.2f} ms, resize and "
          f"crop {ms[1]:.2f} ms, RandAugment {ms[2]:.2f} ms, normalise and erase {ms[3]:.2f} ms; "
          f"{ms.sum():.2f} ms in all [{card}]")


def ft_cli_hooks(cli, record: dict):
    """Context: the CLI's train steps (the window's host clock, synchronised
    at both ends), its train loader's waits, validation, test and checkpoint
    seconds recorded into `record`."""
    step_factory, evaluate, final_test = cli.make_cls_train_step, cli.evaluate, cli.final_test

    def timed_factory(model, optimizer):
        step = step_factory(model, optimizer)

        def run(video, targets):
            t0 = time.perf_counter()
            loss = step(video, targets)
            record["calls"].append((record["steps"], t0 - record["arrived"],
                                    time.perf_counter() - t0))
            record["steps"] += 1
            i = record["steps"] - 1
            if i in (FT_WINDOW.start - 1, FT_WINDOW.stop - 1):
                torch.cuda.synchronize()
                record["t0" if i < FT_WINDOW.start else "t1"] = time.perf_counter()
            return loss

        return run

    class TimedLoader(cli.ShardedLoader):
        def __iter__(self):
            it = super().__iter__()
            while True:
                t0 = time.perf_counter()
                batch = next(it, None)
                if batch is None:
                    return
                if self.shuffle:
                    record["arrived"] = time.perf_counter()
                    record["waits"].append((record["steps"], record["arrived"] - t0))
                yield batch

    class TimedCheckpoints(cli.CheckpointManager):
        def save_epoch(self, epoch, state, val_log=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tags = super().save_epoch(epoch, state, val_log)
            record["saves"].append((tags, time.perf_counter() - t0,
                                    sum(os.path.getsize(self.path(t)) for t in tags)))
            return tags

    def timed(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            record[key].append(time.perf_counter() - t0)
            return out
        return run

    return patched((cli, "make_cls_train_step", timed_factory),
                   (cli, "ShardedLoader", TimedLoader),
                   (cli, "CheckpointManager", TimedCheckpoints),
                   (cli, "evaluate", timed(evaluate, "val_s")),
                   (cli, "final_test", timed(final_test, "test_s")))


def ft_cli(dev, card: str, tree: str, pth: str, out_dir: str, resident: dict) -> None:
    """The three modes through the CLI twin and its aliases, from files."""
    from tvts_torch.cli import run_class_finetuning as cli
    from tvts_torch.cli import run_class_linear, run_class_zero
    from tvts_torch.downstream.cls_dataset import VideoClsDataset
    from tvts_torch.downstream.model import FinetuneViT, load_pretrain_video_tower
    from tvts_torch.utils.convert import load_reference_state_dict

    common = ["--data_path", tree, "--data_root", tree, "--finetune", pth, *FT_FLAGS]
    record = {"steps": 0, "waits": [], "calls": [], "val_s": [], "test_s": [], "saves": []}
    t0 = time.perf_counter()
    with ft_cli_hooks(cli, record):
        out = cli.main(["--mode", "finetune", *common, *FT_RECIPES["finetune"],
                        "--output_dir", os.path.join(out_dir, "ft")])
    wall = time.perf_counter() - t0
    losses = np.asarray(out["losses"])
    res, acc = out["test"]
    n_steps = SSV2_SPLITS["train"] // FT_B
    if len(losses) != n_steps or not np.isfinite(losses).all() or out["ema"] is None:
        raise AssertionError(f"finetune from files: losses {losses}")
    if res["n"] != SSV2_SPLITS["test"] or acc.count.tolist() != [6] * SSV2_SPLITS["test"]:
        raise AssertionError(f"the multi-view test merged {acc.count.tolist()}")
    sec = record["t1"] - record["t0"]
    wait = sum(w for i, w in record["waits"] if i in FT_WINDOW)
    clips = FT_B * len(FT_WINDOW)
    print(f"[14] run_class_finetuning --mode finetune --model_ema (ft_ssv2.sh's flags, 1 epoch "
          f"of {n_steps} steps, {cli.TRAIN_WORKERS} train workers): losses finite ({losses[0]:.4f} "
          f"... {losses[-1]:.4f}); over steps {FT_WINDOW.start + 1}-{FT_WINDOW.stop}: "
          f"{clips / sec:.2f} clips/s, {sec / len(FT_WINDOW) * 1e3:.1f} ms a step, host share "
          f"{wait / sec:.3f}; device-resident {resident['finetune']['clips_s']:.2f} clips/s "
          f"({resident['finetune']['ms']:.2f} ms a step) [{card}]")
    prep = np.mean([p for i, p, _ in record["calls"] if i in FT_WINDOW])
    call = np.mean([c for i, _, c in record["calls"] if i in FT_WINDOW])
    print(f"[14] the window's host clock a step: waiting on the train loader "
          f"{1e3 * wait / len(FT_WINDOW):.1f} ms, mixup and the copy to the card "
          f"{1e3 * prep:.1f} ms, the step's call (enqueueing its kernels) {1e3 * call:.1f} ms; "
          f"the device busy ~{resident['busy']:.1f} ms a step (the resident profile); seconds "
          f"waiting on the loader before each step: "
          + json.dumps([round(w, 4) for _, w in record["waits"]]) + f" [{card}]")
    print(f"[14] validation ({SSV2_SPLITS['val']} videos) {record['val_s'][0]:.2f} s, val top1 "
          f"{100 * out['val_top1'][0]:.2f}%; multi-view test ({SSV2_SPLITS['test']} videos x 6 "
          f"views, each video's 6 merged) {record['test_s'][0]:.2f} s, top1 "
          f"{100 * res['top1']:.2f}% top5 {100 * res['top5']:.2f}%; "
          + "; ".join(f"checkpoint {tags} {size / 2 ** 30:.3f} GiB in {s:.2f} s"
                      for tags, s, size in record["saves"])
          + f"; the run {wall:.1f} s [{card}]")
    cls_item_split(VideoClsDataset(os.path.join(tree, "train.csv"), tree, mode="train",
                                   num_frames=FT_ARCH["num_frames"],
                                   input_size=FT_ARCH["img_size"],
                                   short_side_size=FT_ARCH["img_size"]), card)
    del out
    torch.cuda.empty_cache()

    linear_dir = os.path.join(out_dir, "linear_data")  # rows of the same videos
    os.makedirs(linear_dir, exist_ok=True)
    for split, n in (("train", FT_LINEAR_STEPS * FT_B), ("val", FT_B)):
        with open(os.path.join(tree, f"{split}.csv")) as f:
            rows = f.read().splitlines()[:n]
        with open(os.path.join(linear_dir, f"{split}.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    t0 = time.perf_counter()
    out = run_class_linear.main(["--data_path", linear_dir, *common[2:], *FT_RECIPES["linear"],
                                 "--output_dir", os.path.join(out_dir, "linear")])
    wall = time.perf_counter() - t0
    want = FinetuneViT(**FT_ARCH)
    want.reset_parameters(torch.Generator().manual_seed(0))
    load_pretrain_video_tower(want, load_reference_state_dict(pth))
    want = want.state_dict()
    moved = {k: not torch.equal(v.cpu(), want[k]) for k, v in out["model"].state_dict().items()}
    frozen_same = not any(m for k, m in moved.items() if not k.startswith(("head.", "fc_norm.")))
    probe_moved = all(m for k, m in moved.items() if k.startswith(("head.", "fc_norm.")))
    losses = np.asarray(out["losses"])
    print(f"[14] run_class_linear (linear_ssv2.sh's flags, {len(losses)} steps over the first "
          f"{FT_LINEAR_STEPS * FT_B} train videos, {FT_B} val, no test; {wall:.1f} s): "
          f"losses finite {bool(np.isfinite(losses).all())}; every backbone tensor bit for bit "
          f"the checkpoint's: {frozen_same}; head and fc_norm moved: {probe_moved}; val top1 "
          f"{100 * out['val_top1'][0]:.2f}% [{card}]")
    if not (frozen_same and probe_moved and len(losses) == FT_LINEAR_STEPS
            and np.isfinite(losses).all()):
        raise AssertionError("the linear probe moved the backbone or left the head")
    del out
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out = run_class_zero.main([*common, "--output_dir", os.path.join(out_dir, "zero")])
    wall = time.perf_counter() - t0
    ds = VideoClsDataset(os.path.join(tree, "val.csv"), tree, mode="validation",
                         num_frames=FT_ARCH["num_frames"], input_size=FT_ARCH["img_size"],
                         short_side_size=FT_ARCH["img_size"])
    video = torch.from_numpy(np.stack([ds[i]["video"] for i in range(FT_B)])).to(dev)
    with torch.inference_mode():
        got = out["model"](video, None)[:, 0].float().cpu().numpy()
    same = bool(np.array_equal(got, out["feats"][:FT_B]))
    print(f"[14] run_class_zero: v2v over {len(out['labels'])} val clips "
          f"{json.dumps(out['metrics'])}, {wall:.1f} s; the first batch's features bit for bit "
          f"JointViT(video)[:, 0]: {same} [{card}]")
    if not same or not np.isfinite(out["feats"]).all():
        raise AssertionError("zero-shot v2v features disagree with the JointViT CLS rows")


def downstream_phase(dev, card: str, bk, bb, ta, root: str, backend: str | None) -> None:
    """Phase 14 (module notes): the v1 SSV2 downstream stack at full width."""
    import contextlib

    from tvts_torch.data import video_reader
    from tvts_torch.downstream.model import MODEL_SIZES

    t_phase = time.perf_counter()
    reset_launch_counts(bk, bb, ta)
    pth = ft_pretrain_pth(dev, os.path.join(root, "v1_pretrain.pth"))
    model = ft_model(dev, card, pth)
    video, targets = ft_step0(dev, card, model)
    resident = ft_resident(dev, card, model, video, targets)
    del model, video, targets
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tree, specs = ssv2_tree(os.path.join(root, "ssv2"), SSV2_SPLITS,
                            workers=len(os.sched_getaffinity(0)), write=backend is not None)
    print(f"[14] " + json.dumps({"decode_backend": backend, "clips": len(specs),
                                 "frames": SSV2_CLIP[0], "fps": SSV2_CLIP[1],
                                 "shape": SSV2_CLIP[2], "write_s": round(time.perf_counter() - t0,
                                                                          3)}))
    decode = (contextlib.nullcontext() if backend is not None
              else injected_decode(video_reader, specs))
    with decode:
        ft_cli(dev, card, tree, pth, os.path.join(root, "results_ft"), resident)
    # the CLI's evaluation runs the blocks on the kernels (make_cls_eval_step's
    # use_fused, on the card in bf16): the finetune run's validation and
    # multi-view test and the linear probe's validation, each call the H7 core
    # and H3 once a block, as do ft_resident's fused calls; training and the
    # zero-shot run stay eager
    calls = (-(-SSV2_SPLITS["val"] // FT_B) + -(-SSV2_SPLITS["test"] * 6 // FT_B) + 1)
    per_block = (calls + resident["fused_calls"]) * MODEL_SIZES["vit_base_patch16_224"]["depth"]
    expect_launches("the downstream phase", launch_counts(bk, bb, ta),
                    {"fused_mlp_block": per_block, "fused_text_attention_block": per_block,
                     "text_core": per_block})
    print(f"[14] the CLI's {calls} eval calls and ft_resident's {resident['fused_calls']} "
          f"launched the attention sub-path, the H7 core and H3 {per_block} times each, no other "
          f"hand-written kernel; downstream phase {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    # ---- phase 1: the card --------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device -- this script runs only on the card",
              file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda")
    print(f"[1] card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    from tvts_torch.eval.embed import embed_texts, make_embed_fns
    from tvts_torch.eval.feature_extraction import extract_video_feature
    from tvts_torch.eval.zero_recognition import run_recognition
    from tvts_torch.eval.zero_ret import run_retrieval
    from tvts_torch.eval.zero_ssv2_mc import run_ssv2_mc
    from tvts_torch.ops import attention_cores as ac
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
        elif "Performance Loss" in line:  # e.g. wgmma serialised by ptxas
            print(f"[2]   {line.split(':', 1)[1].strip()}")

    if "--profile" in sys.argv[1:]:
        profile_phase(dev, card, bk, bb, ta)
        return 0
    if "--ln-gemm" in sys.argv[1:]:
        return ln_gemm_phase(dev, card, bk, sys.argv[sys.argv.index("--ln-gemm") + 1:])

    # ---- phase 3: kernel parity ---------------------------------------------
    max_err = parity_phase(dev, bk, bb, ta, ac)
    space_core_rows(dev, bk)

    # ---- phase 4: main path -------------------------------------------------
    ext = extraction_phase("4", "TVTSv2_B_16", dev, bk, bb, ta, n_clips=21, batch_size=8,
                           noise_seed=1)
    cfg, model, model32, clips, fused = (ext[k] for k in ("cfg", "model", "model32", "clips",
                                                           "fused"))
    launches, per_forward, n_forwards = ext["launches"], ext["per_forward"], ext["n_forwards"]
    v, tc = cfg.vision, cfg.text
    feat = extract_video_feature(model, clips[:1], use_fused=True)
    if feat.shape != (1, v.output_dim) or not np.isfinite(feat).all():
        raise AssertionError(f"extract_video_feature: shape {feat.shape}")
    print(f"[4] extract_video_feature -> {feat.shape}, cosine to batch row "
          f"{cos_rows(feat, fused[:1])[0]:.6f}")
    launches.update(use_pallas_phase("4", ext, dev, bk, bb, ta))

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
          f"{ {k: n for k, n in zs_launches.items() if n} }")
    want = {name: n * video_forwards for name, n in per_forward.items()}
    want["fused_text_attention_block"] = want["text_core"] = (tc.layers - 1) * text_forwards
    expect_launches("zero-shot", zs_launches, want)
    for name in ("fused_text_attention_block", "text_core"):
        launches[name] = zs_launches[name]
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
        with no_tf32():
            texts[path] = np.concatenate([embed_texts(embed_text, captions[i:i + 8], dev,
                                                      batch_size=8)
                                          for i in range(0, len(captions), 8)])
    if texts["kernels"].shape != (len(captions), tc.output_dim) \
            or not np.isfinite(texts["kernels"]).all():
        raise AssertionError(f"text embeddings: shape {texts['kernels'].shape} or non-finite")
    t16 = cos_rows(texts["kernels"], texts["eager"]).min()
    t32 = cos_rows(texts["kernels"], texts["eager32"]).min()
    print(f"[5] text cosine, kernel path vs eager: min {t16:.6f} (bf16, >= {COS_BF16}), "
          f"min {t32:.6f} (f32, >= {COS_F32})")
    if t16 < COS_BF16 or t32 < COS_F32:
        raise AssertionError("text kernel path disagrees with the eager tower")

    # ---- phase 10: the data path, from a config file and video files --------
    data_rates = data_phase(dev, card, ext, bk, bb, ta)
    del model32, ext

    # ---- phase 7: train main path -------------------------------------------
    train = train_phase(dev, bk, bb, ta)
    launches.update({name: n for name, n in train["launches"].items()
                     if name in REPLACES and not launches.get(name)})

    # ---- phase 6: times -----------------------------------------------------
    B = 64
    resident = extraction_rate("6", cfg, model, B, dev, card, iters=5)["kernels"]
    print(f"[10] B/16 retrieval from files {data_rates['clips_s']:.2f} clips/s (host share "
          f"{data_rates['host_share']:.3f}, {data_rates['workers']} workers) against "
          f"{resident:.2f} clips/s device-resident (phase 6, B={B}) [{card}]")
    expect_profiles(forward_profile(cfg, model, B, dev, card, bk))
    ln_gemm_rows = ln_gemm_table(dev, card, bk)
    ln_rows_rows = ln_rows_table(dev, card, bk)
    times = block_times(bk, v, B, dev, card)
    core_ms, core_bound, core_library = space_core_times(dev, card, bk, cfg, B)
    core = {"B": B, "ms": core_ms, "bound_ms": core_bound[0], "bound_by": core_bound[1],
            "library_ms": core_library}
    library = {}
    wgrad_rows, line = wgrad_table(dev, card, bb)
    times["wgrad"] = (line["ms"], line["plain_ms"], line["bound"])
    library["wgrad"], max_err["wgrad"] = line["library_ms"], line["max_abs_err"]
    line = time_core_bwd_times(dev, card, bb)
    times["time_core_backward"] = (line["ms"], line["plain_ms"], line["bound"])
    library["time_core_backward"] = line["library_ms"]
    max_err["time_core_backward"] = line["max_abs_err"]
    time_core_bwd_digests(dev, bb)
    for name, lines in (("space_core_backward", space_core_bwd_times(dev, card, bb)),
                        ("ln_backward", ln_bwd_times(dev, card, bb))):
        line = lines["B/16 train"]
        times[name] = (line["ms"], line["plain_ms"], line["bound"])
        library[name], max_err[name] = line["library_ms"], line["max_abs_err"]
    space_core_bwd_digests(dev, bb)
    ln_bwd_digests(dev, bb)

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
    core_lines = text_core_times(dev, card, ta)
    for name, line in core_lines["B/16 sort"].items():
        times[name] = (line["ms"], line["plain_ms"], line["bound"])
        library[name], max_err[name] = line["library_ms"], line["max_abs_err"]
    joint_core = {label: dict(B=shape[0], S=shape[1], H=shape[2], d=shape[3],
                              ms=core_lines[label]["text_core"]["ms"],
                              plain_ms=core_lines[label]["text_core"]["plain_ms"],
                              bound_ms=core_lines[label]["text_core"]["bound"][0],
                              bound_by=core_lines[label]["text_core"]["bound"][1],
                              library_ms=core_lines[label]["text_core"]["library_ms"],
                              max_abs_err=core_lines[label]["text_core"]["max_abs_err"])
                  for label, shape in TEXT_CORE_FWD_SHAPES.items()}
    del model
    train_times(dev, card, bk, bb, ta, ac, train, times, library)
    core_f32_times(dev, card, ac, times, library)
    del train
    torch.cuda.empty_cache()

    # ---- phases 11-13: pretraining from files, the Trainer, TVTS v1 ----------
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tvts_pretrain_") as root:
        config_path, decode, backend = pretrain_files(root, "11")
        with decode:
            bare = pretrain_phase(dev, card, bk, bb, ta, config_path, backend)
            trainer_phase(dev, card, bk, bb, ta, root, config_path, bare)
            # ---- phase 15: --fsdp sharding through the B/16 kernel step ------
            fsdp_b16_phase(dev, card, bk, bb, ta)
            # ---- phase 16: --tp through the B/16 kernel step -----------------
            tp_b16_phase(dev, card, bk, bb, ta)
            # ---- phase 17: sequence parallelism through the B/16 steps -------
            sp_b16_phase(dev, card, bk, bb, ta)
            # ---- phase 13: the TVTS v1 family, on the same YT-Temporal tree ------
            v1_phase(dev, card, bk, bb, ta, root, config_path)
        # ---- phase 14: the v1 SSV2 downstream stack, through the CLI twin -------
        downstream_phase(dev, card, bk, bb, ta, root, backend)
        # ---- phase 18: the Frozen-style encoder and train transforms ------------
        frozen_phase(dev, card, bk, bb, ta, root)

    # ---- phase 9 (B/32) and phase 8 (H/14), with their times -----------------
    b32_phase(dev, card, bk, bb, ta)
    torch.cuda.empty_cache()
    h14_phase(dev, card, bk, bb, ta)

    unlaunched = [name for name in REPLACES if not launches.get(name)]
    if unlaunched:
        raise AssertionError(f"kernels that no main path launched: {unlaunched}")
    print(f"torch.profiler: not measured or by CUDA events in this run: {UNPROFILED}")
    print(card)
    print(json.dumps({"ln_gemm": ln_gemm_rows}))
    print(json.dumps({"ln_rows": ln_rows_rows}))
    print(json.dumps({"wgrad": wgrad_rows}))
    print(json.dumps({"space_core": core}))
    # the forward-only H7 core at head dim 88 (no TPU kernel of its own: the
    # JAX package runs the joint towers eagerly), its library call one
    # scaled_dot_product_attention forward
    print(json.dumps({"text_core_forward": joint_core}))
    # library_ms: no single PyTorch call computes a whole sub-path (LayerNorm,
    # the products, divided or causal attention, activation and residual, or
    # their gradients), so those rows are null. A row of one kernel has its
    # one call: the H9 cores one masked scaled_dot_product_attention
    # (core_library_call); wgrad's product one torch.matmul(a.t(), b)
    # (wgrad_table); the backward time and space cores one masked
    # scaled_dot_product_attention backward over their divided_mask
    # (core_backward_library_call: time_core_bwd_times, space_core_bwd_times);
    # ln_backward one native_layer_norm_backward (ln_bwd_times); the H7 cores
    # one scaled_dot_product_attention forward or backward (text_core_times)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": max_err[name],
         "ms": times[name][0], "plain_ms": times[name][1], "bound_ms": times[name][2][0],
         "bound_by": times[name][2][1], "library_ms": library.get(name)}
        for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
