"""TVTS v1 distributed pretraining, the twin of scripts/train_dist_TVTS.py
(the reference's v1/train_dist_TVTS.py): YT-Temporal pretraining of the
joint-attention ViT-B and DistilBERT towers with one AdamW group (the
config's lr, betas and weight decay, eps 1e-6) and milestone LR decay.

    python -m tvts_torch.cli.train_dist_TVTS -c tvts_tpu/configs/v1-dist-yt-pt.json --bert_vocab vocab.txt

The JAX script's flags, plus `--device` (cuda, the default, or cpu) and
`--bf16/--no-bf16` (bf16 compute over float32 parameters, LayerNorms and
softmax in float32: the JAX script's `TVTSv1(cfg, dtype=bfloat16)`).
Weights: the JAX package's initializers, then `--mae_init` (an MAE 2-D
checkpoint inflated over the tubelet), then the config's `load_checkpoint`,
each overlaid on what came before. Every loader gets `per_tube_masks =
n_tubes`. One process a card, as train_dist_TVTSv2: `--coordinator
host:port --num_processes N --process_id i` or torchrun's environment;
`--tp T` splits the JointViT's and the sort head's heads and MLP hidden
width over groups of T ranks, which train on the same rows
(parallel/tensor_parallel.py; DistilBERT stays replicated, as no JAX rule
names its layers), as the JAX script's `--tp`; `--fsdp N` shards the
parameters (under tp, the tp slices) and AdamW state over groups of N ranks
(parallel/partition.py), as the JAX script's `--fsdp`; `-r <checkpoint
.pth>` resumes from that file and re-shards it; only rank 0 writes
checkpoints, in the reference layout.

The repo's `v1-dist-cc-web-pt.json` is refused before any loader is built
(`check_loaders`): the JAX script cannot run it either. It sets
`per_tube_masks` on every loader (scripts/train_dist_TVTS.py:88), which
WebVid does not take (tvts_tpu/data/datasets.py:33-46: a TypeError); and
CC3M (tvts_tpu/data/image_datasets.py:96) and WebVid
(tvts_tpu/data/datasets.py:122-125) give a 2-D keep set [B, n_keep], where
JointViT indexes a per-tube one [B, n_tubes, n_keep]
(tvts_tpu/models/joint_vit.py:84-86).
"""

from __future__ import annotations

import argparse

import torch

from tvts_torch.models.factory import build_v1_model
from tvts_torch.models.tvts_v1 import TVTSv1Config
from tvts_torch.parallel.mesh import create_mesh
from tvts_torch.parallel.partition import shard_params
from tvts_torch.train.optim import OptimizerConfig, make_v1_optimizer
from tvts_torch.train.trainer import Trainer, wordpiece_tokenize_fn
from tvts_torch.utils.checkpoint import CheckpointManager
from tvts_torch.utils.config import ConfigParser, read_json

# the datasets that give v1's per-tube keep sets
PER_TUBE_DATASETS = ("YTTemporal",)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="TVTS v1 pretraining")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-r", "--resume", default=None, help="a checkpoint .pth to resume from")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous (torch.distributed tcp://)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--schedule", type=int, nargs="*", default=[10])
    ap.add_argument("--fsdp", type=int, default=1,
                    help="shard parameters and optimizer state over groups of this many ranks")
    ap.add_argument("--tp", type=int, default=1,
                    help="split the heads and MLP hidden width over groups of this many ranks")
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                    help="bf16 compute over f32 parameters; --no-bf16 runs f32")
    ap.add_argument("--bert_vocab", default=None,
                    help="path to distilbert-base-uncased vocab.txt")
    ap.add_argument("--mae_init", default=None,
                    help="path to mae_pretrain_vit_base.pth for 2D->3D init")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def check_loaders(dl_specs: list) -> None:
    """Refuse loaders whose items carry no per-tube keep set (module notes)."""
    names = [spec["args"].get("dataset_name") for spec in dl_specs]
    other = [n for n in names if n not in PER_TUBE_DATASETS]
    if other:
        raise ValueError(
            f"TVTS v1 trains on per-tube keep sets, which {other} do not give: the JAX script "
            "cannot run this config either. It sets per_tube_masks on every loader "
            "(scripts/train_dist_TVTS.py:88), which WebVid does not take "
            "(tvts_tpu/data/datasets.py:33-46); and ConceptualCaptions3M and WebVid give a "
            "2-D keep_ind [B, n_keep] where JointViT indexes keep_ind[:, :n_tubes, :] "
            f"(tvts_tpu/models/joint_vit.py:84-86). Loaders here must be {PER_TUBE_DATASETS}.")


def build_trainer(args: argparse.Namespace, mesh) -> Trainer:
    """The JAX script's set-up, on this process's device and rank."""
    from tvts_torch.utils.convert import (
        convert_v1_state_dict,
        inflate_mae_2d_to_3d,
        load_reference_state_dict,
        merge_params,
    )

    raw = read_json(args.config)
    dl_specs = raw["data_loader"]
    if isinstance(dl_specs, dict):
        dl_specs = [dl_specs]
    check_loaders(dl_specs)
    rank0 = mesh.rank == 0
    config = ConfigParser(raw, resume=args.resume, test=not rank0)

    vp = config["arch"]["args"].get("video_params", {})
    cfg = TVTSv1Config(num_frames=vp.get("num_frames", 16))
    model = build_v1_model(cfg, device=mesh.device,
                           compute_dtype=torch.bfloat16 if args.bf16 else None)
    if args.mae_init:
        sd = inflate_mae_2d_to_3d(load_reference_state_dict(args.mae_init), cfg.tubelet_size)
        merge_params(model, convert_v1_state_dict({f"video_model.{k}": v for k, v in sd.items()}))
        print("video tower initialized from MAE IN-1K weights (2D->3D inflated)")
    lc = config["arch"]["args"].get("load_checkpoint")
    if lc:
        merge_params(model, convert_v1_state_dict(load_reference_state_dict(lc)))

    loaders = []
    for spec in dl_specs:
        spec["args"].setdefault("per_tube_masks", cfg.n_tubes)
        loaders.append(config.initialize_dataset_loader(spec)[1])

    ocfg_json = config.get("optimizer", {"args": {}})["args"]
    steps_per_epoch = max(max(len(dl) for dl in loaders), 1) * len(loaders)
    ocfg = OptimizerConfig(schedule=tuple(args.schedule), steps_per_epoch=steps_per_epoch)
    shard_params(model, mesh)  # rank 0's weights, sharded with --tp > 1 and --fsdp > 1
    optimizer = make_v1_optimizer(model, lr=ocfg_json.get("lr", 1e-4),
                                  betas=ocfg_json.get("betas", [0.9, 0.999]),
                                  weight_decay=ocfg_json.get("weight_decay", 0.0))

    tcfg = config["trainer"]
    ckpt = CheckpointManager(config.save_dir, tcfg.get("save_period", 1),
                             tcfg.get("monitor", "off"), arch=config["arch"]["type"],
                             config=config.config, writes=rank0)
    return Trainer(model, optimizer, ocfg, loaders, [], epochs=tcfg.get("epochs", 16),
                   mesh=mesh, ckpt_manager=ckpt,
                   max_samples_per_epoch=tcfg.get("max_samples_per_epoch"),
                   tokenize_fn=wordpiece_tokenize_fn(args.bert_vocab,
                                                     max_length=cfg.max_text_len),
                   epoch_loader=tcfg.get("epoch_loader"))


def main(argv=None) -> Trainer:
    """Train; returns the Trainer after the last epoch. The process group it
    started is destroyed on return."""
    args = parse_args(argv)
    with create_mesh(fsdp=args.fsdp, tp=args.tp, coordinator=args.coordinator,
                     num_processes=args.num_processes, process_id=args.process_id,
                     device=args.device) as mesh:
        trainer = build_trainer(args, mesh)
        if args.resume:
            trainer.resume(args.resume)
        trainer.train()
    return trainer


if __name__ == "__main__":
    main()
