"""TVTSv2 distributed pretraining, the twin of scripts/train_dist_TVTSv2.py
(the reference's v2/train_dist_TVTSv2_ViT_{B_32,B_16,H_14}.py): a JSON config
and command-line overrides (-lr, -bs, --schedule), YT-Temporal and WebVid
joint training, the 4-group AdamW, milestone LR decay, init validation and
checkpoints.

    python -m tvts_torch.cli.train_dist_TVTSv2 -c tvts_tpu/configs/dist-yt-web-pt-vit-b-16-fused.json

One process a card: several cards take `--coordinator host:port
--num_processes N --process_id i` in each process, or torchrun's
environment (`torchrun --nproc_per_node 4 -m tvts_torch.cli.train_dist_TVTSv2
-c ...`). `--device cpu` trains on the CPU (gloo between processes).
`--tp T` splits the attention heads and the MLPs' hidden width over groups
of T ranks, which train on the same rows (Megatron's column -> row pairs,
parallel/tensor_parallel.py), as the JAX script's `--tp`; the kernel path
(`--fused_kernels`, `trainer.kernels`) gathers each block's slices whole at
the kernels, as the JAX kernel step does. `--fsdp N` shards the parameters
(under tp, the tp slices) and AdamW state over groups of N ranks
(parallel/partition.py), as the JAX script's `--fsdp`; the batch is split
over the world / T ranks, dp x fsdp. `-r <checkpoint .pth>` resumes from
that file, as the reference does (the JAX script looks for the latest epoch
in the new run's own directory); under `--fsdp` or `--tp` it re-shards the
file's full state. Only rank 0 writes checkpoints (gathered from the shards
into the reference layout), logs, scalars and pages.
"""

from __future__ import annotations

import argparse
import logging
from functools import partial

import torch

from tvts_torch.models.factory import build_model
from tvts_torch.parallel.mesh import create_mesh
from tvts_torch.parallel.partition import shard_params
from tvts_torch.train.optim import OptimizerConfig, make_optimizer
from tvts_torch.train.trainer import Trainer
from tvts_torch.utils.checkpoint import CheckpointManager
from tvts_torch.utils.config import ConfigParser, read_json

log = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="TVTSv2 pretraining")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-r", "--resume", default=None, help="a checkpoint .pth to resume from")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's rendezvous (torch.distributed tcp://)")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--schedule", type=int, nargs="*", default=[6, 8])
    ap.add_argument("--fsdp", type=int, default=1,
                    help="shard parameters and optimizer state over groups of this many ranks")
    ap.add_argument("--tp", type=int, default=1,
                    help="split the heads and MLP hidden width over groups of this many ranks")
    ap.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                    help="bf16 compute over f32 masters; --no-bf16 runs f32")
    ap.add_argument("--fused_kernels", action="store_true",
                    help="the towers through the hand-written kernels (as trainer.kernels.fused)")
    ap.add_argument("-lr", "--learning_rate", type=float, default=None)
    ap.add_argument("-bs", "--batch_size", type=int, default=None)
    ap.add_argument("--clip_init", default=None,
                    help="a CLIP / OpenCLIP .pt state dict to initialise the towers from")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def build_trainer(args: argparse.Namespace, mesh) -> Trainer:
    """The JAX script's set-up, on this process's device and rank."""
    from tvts_torch.utils.convert import convert_clip_full, load_reference_state_dict, merge_params
    from tvts_torch.utils.logging import ScalarWriter, setup_logging

    rank0 = mesh.rank == 0
    config = ConfigParser(read_json(args.config), resume=args.resume, test=not rank0)
    arch = config["arch"]["type"]
    cfg, model = build_model(
        arch, load_checkpoint=config["arch"]["args"].get("load_checkpoint") or None,
        eval_mode=False, dtype=torch.float32, device=mesh.device,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        remat=arch == "TVTSv2_H_14", strict=False)
    if args.clip_init:
        # the visual tower through the in_proj -> qkv remap, the text tower as
        # it is; timeattn, ln_3 and temporal_embedding keep their fresh values
        missing, unused = merge_params(
            model, convert_clip_full(load_reference_state_dict(args.clip_init)))
        print(f"towers initialized from CLIP weights: {args.clip_init} ({len(missing)} "
              f"parameters kept their initial values, {len(unused)} entries unused)")

    dl_specs = config["data_loader"]
    if isinstance(dl_specs, dict):
        dl_specs = [dl_specs]
    overrides = {"batch_size": args.batch_size} if args.batch_size else {}
    loaders, val_loaders = [], []
    for spec in dl_specs:
        loaders.append(config.initialize_dataset_loader(spec, overrides)[1])
        try:
            val_loaders.append(config.initialize_dataset_loader(
                spec, {**overrides, "split": "val", "shuffle": False})[1])
        except (FileNotFoundError, KeyError) as e:
            print(f"no val split for {spec['args'].get('dataset_name')}: {e!r}")

    steps_per_epoch = max(max(len(dl) for dl in loaders), 1)
    ocfg = OptimizerConfig(lr_new=args.learning_rate or 1e-4, text_layers=cfg.text.layers,
                           text_tune_layers=6 if arch == "TVTSv2_H_14" else 3,
                           schedule=tuple(args.schedule),
                           steps_per_epoch=steps_per_epoch * len(loaders))
    shard_params(model, mesh)  # rank 0's weights, sharded with --tp > 1 and --fsdp > 1
    optimizer = make_optimizer(model, ocfg)

    tcfg = config["trainer"]
    ckpt = CheckpointManager(config.save_dir, tcfg.get("save_period", 1),
                             tcfg.get("monitor", "off"), arch=arch, config=config.config,
                             writes=rank0)
    setup_logging(str(config.log_dir) if rank0 else None, verbosity=tcfg.get("verbosity", 2))
    writer = ScalarWriter(str(config.log_dir), tensorboard=tcfg.get("tensorboard", False)) \
        if rank0 else None
    if tcfg.get("neptune"):
        # reference configs may ask for a Neptune observer
        # (train_dist_TVTSv2_ViT_B_16.py:210-216); there is no network tracker here
        log.warning("config requests neptune=true: no network trackers here; scalars are "
                    "written to %s (JSONL / TensorBoard)", config.log_dir)
    visualizer = None
    if rank0 and config.get("visualizer", {}).get("type"):
        from tvts_torch.utils.visualizer import RetrievalVis

        visualizer = RetrievalVis(config["name"], str(config._web_log_dir))
    apply_fn = None
    if args.fused_kernels or tcfg.get("kernels", {}).get("fused"):
        from tvts_torch.ops.fused_forward import train_apply
        from tvts_torch.ops.kernel_config import resolve_kernel_config, train_apply_kwargs

        # trainer.kernels first, then the arch's preset; with text_mode "pallas"
        # the frozen text blocks take the dx-only backward (text_tune_from)
        kcfg = resolve_kernel_config(arch, tcfg.get("kernels"))
        apply_fn = partial(train_apply, **train_apply_kwargs(kcfg, ocfg))
        print(f"fused train kernels enabled: {kcfg}")
    return Trainer(model, optimizer, ocfg, loaders, val_loaders, epochs=tcfg.get("epochs", 10),
                   mesh=mesh, ckpt_manager=ckpt, init_val=tcfg.get("init_val", False),
                   max_samples_per_epoch=tcfg.get("max_samples_per_epoch"),
                   context_length=cfg.text.context_length, writer=writer,
                   visualizer=visualizer, apply_fn=apply_fn,
                   temperature=config.get("loss", {}).get("args", {}).get("temperature", 0.05),
                   epoch_loader=tcfg.get("epoch_loader"), profile_dir=tcfg.get("profile_dir"),
                   profile_steps=tuple(tcfg.get("profile_steps", (10, 13))))


def main(argv=None) -> Trainer:
    """Train; returns the Trainer (its model, optimizer and step count) after
    the last epoch. The process group it started is destroyed on return."""
    args = parse_args(argv)
    with create_mesh(fsdp=args.fsdp, tp=args.tp, coordinator=args.coordinator,
                     num_processes=args.num_processes, process_id=args.process_id,
                     device=args.device) as mesh:
        trainer = build_trainer(args, mesh)
        if args.resume:
            trainer.resume(args.resume)
        trainer.train()
        if trainer.writer is not None:
            trainer.writer.close()
    return trainer


if __name__ == "__main__":
    main()
