"""Video classification fine-tuning, linear probe and zero-shot v2v
retrieval, the twin of scripts/run_class_finetuning.py (the reference's
v1/downstream/run_class_{finetuning,linear,zero}.py in one script,
`--mode finetune|linear|zero`):

    python -m tvts_torch.cli.run_class_finetuning --data_path data/SSV2 --finetune TVTS_yt_pt.pth --output_dir out

The JAX script's flags (scripts/sh/{ft,linear,zero}_ssv2.sh set them), plus
`--device` (cuda, the default, or cpu) and `--bf16/--no-bf16` (bf16 compute
over float32 parameters, LayerNorms and softmax in float32; the JAX script's
`--bf16` cannot be turned off). The VideoMAE recipe as the JAX script runs
it: FinetuneViT with `remat`, its tower from the `--finetune` v1 checkpoint
(`blocks.*`, `patch_embed.*`), mixup / cutmix with label smoothing (or a
smoothed one-hot with `--mixup 0`), the layer-decayed AdamW with the cosine
LR and each group clipped by its own norm, the optional EMA, validation
top-1 after each epoch and a checkpoint of the parameters
(utils/checkpoint.CheckpointManager, save period 10, "max top1"), then the
multi-view test on `test.csv` where it exists. The train loader has 16
workers, validation and test 8. `--mode zero` builds the pretrained JointViT
instead, loads the checkpoint's `video_model` with strict=False, and prints
R@1/5/10 of v2v retrieval over `val.csv`. Run on the CPU with
`--device cpu --no-bf16`.

`--model` names the published sizes (downstream/model.MODEL_SIZES):
`vit_base_patch16_224` (the default) or VideoMAE V2's `vit_giant_patch14_224`
(1408 wide, 40 deep, 16 heads of 88, MLP 6144, patch 14); `--embed_dim`,
`--depth`, `--heads` and `--patch_size` override them where given. On the
card in bf16 the validation and the multi-view test run the blocks on the
kernels (make_cls_eval_step's `use_fused`: the attention sub-path and H3);
training runs the eager model.

`main` returns what it ran: the model, the per-step losses, each epoch's
validation top-1 and the test merge (finetune and linear), or the v2v
metrics, features and labels (zero).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from tvts_torch.data.loader import ShardedLoader
from tvts_torch.downstream.cls_dataset import VideoClsDataset
from tvts_torch.downstream.engine import (
    EmaParams,
    MultiViewAccumulator,
    make_cls_eval_step,
    make_cls_train_step,
    make_finetune_optimizer,
)
from tvts_torch.downstream.mixup import Mixup, one_hot
from tvts_torch.downstream.model import MODEL_SIZES, FinetuneViT, load_pretrain_video_tower
from tvts_torch.utils.checkpoint import CheckpointManager
from tvts_torch.utils.convert import convert_v1_state_dict, load_reference_state_dict, merge_params

TRAIN_WORKERS, EVAL_WORKERS = 16, 8


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="video classification fine-tuning / linear "
                                             "probe / zero-shot v2v retrieval")
    ap.add_argument("--mode", default="finetune", choices=["finetune", "linear", "zero"])
    ap.add_argument("--model", default="vit_base_patch16_224", choices=sorted(MODEL_SIZES))
    ap.add_argument("--embed_dim", type=int, default=None, help="default: the model's")
    ap.add_argument("--depth", type=int, default=None, help="default: the model's")
    ap.add_argument("--heads", type=int, default=None, help="default: the model's")
    ap.add_argument("--patch_size", type=int, default=None, help="default: the model's")
    ap.add_argument("--data_path", required=True,
                    help="dir containing train.csv/val.csv/test.csv")
    ap.add_argument("--data_root", default="")
    ap.add_argument("--nb_classes", type=int, default=174)
    ap.add_argument("--num_frames", type=int, default=16)
    ap.add_argument("--input_size", type=int, default=224)
    ap.add_argument("--short_side_size", type=int, default=224)
    ap.add_argument("--batch_size", type=int, default=12)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--warmup_epochs", type=int, default=5)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--min_lr", type=float, default=1e-6)
    ap.add_argument("--weight_decay", type=float, default=0.05)
    ap.add_argument("--layer_decay", type=float, default=0.75)
    ap.add_argument("--clip_grad", type=float, default=5.0)
    ap.add_argument("--mixup", type=float, default=0.8)
    ap.add_argument("--cutmix", type=float, default=1.0)
    ap.add_argument("--smoothing", type=float, default=0.1)
    ap.add_argument("--model_ema", action="store_true")
    ap.add_argument("--test_num_segment", type=int, default=2)
    ap.add_argument("--test_num_crop", type=int, default=3)
    ap.add_argument("--finetune", default=None, help="pretrain checkpoint")
    ap.add_argument("--output_dir", default="./results/downstream")
    ap.add_argument("--use_flip", action="store_true",
                    help="horizontal flip aug (off for SSV2)")
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                    help="bf16 compute over f32 parameters; --no-bf16 runs f32")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    for key, value in MODEL_SIZES[args.model].items():
        if getattr(args, key, None) is None:
            setattr(args, key, value)
    return args


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_class_finetuning: no CUDA device; pass --device cpu to run on "
                           "the CPU")
    return device


def _dataset(args, split: str, mode: str, **kw) -> VideoClsDataset:
    return VideoClsDataset(os.path.join(args.data_path, f"{split}.csv"), args.data_root,
                           mode=mode, num_frames=args.num_frames, input_size=args.input_size,
                           short_side_size=args.short_side_size, **kw)


def _on(device, array) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device, non_blocking=True)


def run_zero(args, device, compute_dtype) -> dict:
    """The pretrained JointViT's CLS rows over val.csv -> v2v R@1/5/10."""
    from tvts_torch.downstream.zero_v2v import run_zero_v2v
    from tvts_torch.models.joint_vit import JointViT

    model = JointViT(img_size=args.input_size, patch_size=args.patch_size,
                     embed_dim=args.embed_dim, depth=args.depth, heads=args.heads,
                     num_frames=args.num_frames)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if args.finetune:
        loaded = convert_v1_state_dict(load_reference_state_dict(args.finetune))
        tower = {k[len("video_model."):]: v for k, v in loaded.items()
                 if k.startswith("video_model.")}
        merge_params(model, tower or loaded)
    model.to(device).eval()
    model.compute_dtype = compute_dtype
    loader = ShardedLoader(_dataset(args, "val", "validation"), args.batch_size, shuffle=False,
                           drop_last=False, num_workers=EVAL_WORKERS)
    metrics, feats, labels = run_zero_v2v(model, loader, device)
    return {"model": model, "metrics": metrics, "feats": feats, "labels": labels}


def build_finetune_model(args, device, compute_dtype) -> FinetuneViT:
    """FinetuneViT (remat, as the JAX script builds it) from the JAX
    package's initializers (seed 0), its tower from `--finetune`."""
    model = FinetuneViT(num_classes=args.nb_classes, num_frames=args.num_frames,
                        img_size=args.input_size, patch_size=args.patch_size,
                        embed_dim=args.embed_dim, depth=args.depth, heads=args.heads,
                        mlp_ratio=args.mlp_ratio, remat=True)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if args.finetune:
        load_pretrain_video_tower(model, load_reference_state_dict(args.finetune))
        print(f"initialized video tower from {args.finetune}")
    model.to(device).set_compute_dtype(compute_dtype)
    return model


def evaluate(eval_step, loader, device) -> tuple[int, int]:
    """(correct, total) of top-1 over the loader."""
    correct = total = 0
    for batch in loader:
        logits = eval_step(_on(device, batch["video"])).float().cpu().numpy()
        n = len(batch["label"])
        correct += int(np.sum(np.argmax(logits[:n], 1) == np.asarray(batch["label"])))
        total += n
    return correct, total


def final_test(args, eval_step, device) -> tuple[dict, MultiViewAccumulator] | None:
    """The multi-view test over test.csv: per-view logits merged per video."""
    test_csv = os.path.join(args.data_path, "test.csv")
    if not os.path.exists(test_csv):
        return None
    test_ds = _dataset(args, "test", "test", test_num_segment=args.test_num_segment,
                       test_num_crop=args.test_num_crop)
    test_loader = ShardedLoader(test_ds, args.batch_size, shuffle=False, drop_last=False,
                                num_workers=EVAL_WORKERS)
    acc = MultiViewAccumulator(len(test_ds.samples), args.nb_classes)
    for batch in test_loader:
        logits = eval_step(_on(device, batch["video"])).float().cpu().numpy()
        n = len(batch["label"])
        acc.add(batch["sample_index"][:n], logits[:n], np.asarray(batch["label"])[:n])
    res = acc.merge()
    print(f"final test (multi-view merged): top1 {100 * res['top1']:.2f}% "
          f"top5 {100 * res['top5']:.2f}% over {res['n']} videos")
    return res, acc


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = _device(args.device)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    if args.mode == "zero":
        return run_zero(args, device, compute_dtype)

    model = build_finetune_model(args, device, compute_dtype)
    train_loader = ShardedLoader(_dataset(args, "train", "train", use_flip=args.use_flip),
                                 args.batch_size, shuffle=True, num_workers=TRAIN_WORKERS)
    val_loader = ShardedLoader(_dataset(args, "val", "validation"), args.batch_size,
                               shuffle=False, drop_last=False, num_workers=EVAL_WORKERS)
    steps_per_epoch = max(len(train_loader), 1)
    optimizer, _ = make_finetune_optimizer(
        model, args.lr, args.weight_decay, args.epochs, steps_per_epoch,
        warmup_epochs=args.warmup_epochs, min_lr=args.min_lr, layer_decay=args.layer_decay,
        num_layers=model.depth, clip_grad=args.clip_grad, linear_probe=args.mode == "linear")
    train_step = make_cls_train_step(model, optimizer)
    eval_step = make_cls_eval_step(model, use_fused=device.type == "cuda" and args.bf16)
    mixup = Mixup(args.mixup, args.cutmix, label_smoothing=args.smoothing,
                  num_classes=args.nb_classes) if args.mixup > 0 else None
    ema = EmaParams(model) if args.model_ema else None
    ckpt = CheckpointManager(args.output_dir, save_period=10, monitor="max top1",
                             arch=args.model, config=vars(args))

    losses, val_top1 = [], []
    for epoch in range(1, args.epochs + 1):
        train_loader.set_epoch(epoch)
        for i, batch in enumerate(train_loader):
            video_np, labels = batch["video"], np.asarray(batch["label"])
            if mixup is not None:
                video_np, targets = mixup(video_np, labels)
            else:
                targets = one_hot(labels, args.nb_classes, args.smoothing)
            loss = train_step(_on(device, video_np), _on(device, targets))
            losses.append(loss)
            if ema is not None:
                ema.update(model)
            if i % 50 == 0:
                print(f"epoch {epoch} [{i}/{steps_per_epoch}] loss {float(loss):.4f}",
                      flush=True)

        correct, total = evaluate(eval_step, val_loader, device)
        top1 = correct / max(total, 1)
        val_top1.append(top1)
        print(f"epoch {epoch}: val top1 {100 * top1:.2f}%", flush=True)
        ckpt.save_epoch(epoch, {"model": model}, {"top1": top1})

    test = final_test(args, eval_step, device)
    return {"model": model, "optimizer": optimizer, "ema": ema, "ckpt": ckpt,
            "losses": [float(v) for v in torch.stack(losses).cpu()] if losses else [],
            "val_top1": val_top1, "test": test}


if __name__ == "__main__":
    main()
