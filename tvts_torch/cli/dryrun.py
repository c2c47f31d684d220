"""The dry run, the twin of __graft_entry__.py's entry() and dryrun_multichip().

- `entry(device)`: the flagship model's forward, TVTSv2 B/16 in bf16
  compute over f32 parameters, text + video + sort head at B=2 (the example
  of `__graft_entry__.entry`: seeded clips and keep sets, ids
  [SOT, "a", EOT]). On the card unless `device` says otherwise; "meta"
  gives the shapes without computing them.
- `dryrun_multichip(n)`: the training step over an n-process mesh on the
  CPU, gloo between `n` spawned processes, on the tiny config of
  `__graft_entry__._dryrun_impl`: one eager step and one kernel-path step
  (`train_apply`; the kernels' plain versions on CPU tensors), each from the
  same seeded weights sharded by parallel/partition.shard_params; both
  losses finite and within 1e-4 of each other. The mesh takes the JAX dry
  run's factors (__graft_entry__.py:86-89): tp = 2 where n is even, fsdp = 2
  only where n is a multiple of 8, and the rest to dp. The JAX run also
  takes sp = 2 where n is a multiple of 4; sp waits for ROADMAP.md item
  M2d-sp, so its factor goes to dp here.

    python -m tvts_torch.cli.dryrun 4                # the 4-process dry run only
    python -m tvts_torch.cli.dryrun [--device cpu]   # entry's forward, then the 8-process run
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

LOSS_TOL = 1e-4  # eager against the kernel path, as __graft_entry__.py:157-159
JAX_MODULES = ("jax", "flax", "optax", "orbax", "tvts_tpu")


def _batch(cfg, B: int, seed: int, example: bool = False) -> dict:
    """Seeded video [B, T, 3, H, W], keep sets and clip-major ids, as numpy
    arrays: `example` (entry's) ids [SOT, "a", EOT] and padding, else random
    ids with EOT, the largest id, last, and sort labels."""
    v, t = cfg.vision, cfg.text
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(B, v.num_frames, 3, v.input_resolution,
                             v.input_resolution)).astype(np.float32)
    keep = np.stack([rng.permutation(v.patches_per_frame)[:v.n_keep]
                     for _ in range(B)]).astype(np.int32)
    rows = cfg.num_clips * B
    if example:
        ids = np.zeros((rows, t.context_length), dtype=np.int32)
        ids[:, :3] = (49406, 320, 49407)
        return {"video": video, "keep_ind": keep, "text_ids": ids}
    ids = rng.integers(1, t.vocab_size - 2, size=(rows, t.context_length)).astype(np.int32)
    ids[:, -1] = t.vocab_size - 1
    labels = np.tile(np.arange(cfg.num_clips), (B, 1)).astype(np.int32)
    return {"video": video, "keep_ind": keep, "text_ids": ids, "labels": labels}


def entry(device: str | torch.device = "cuda"):
    """(fn, example_args): the B/16 forward (module notes); fn(*example_args)
    returns (text_emb [2, 512], video_emb [2, 512], predict_order [2, 4, 4])."""
    from tvts_torch.models.configs import tvtsv2_b_16
    from tvts_torch.models.factory import build_model
    from tvts_torch.models.tvts_v2 import TVTSv2

    device = torch.device(device)
    if device.type == "meta":
        cfg = tvtsv2_b_16()
        with device:
            model = TVTSv2(cfg)
        model.set_compute_dtype(torch.bfloat16)
    else:
        cfg, model = build_model("TVTSv2_B_16", eval_mode=False, device=device,
                                 compute_dtype=torch.bfloat16)
    batch = {k: torch.from_numpy(a).to(device) for k, a in _batch(cfg, 2, 0, True).items()}
    return model, (batch["video"], batch["text_ids"], batch["keep_ind"])


def tiny_config():
    """__graft_entry__._dryrun_impl's config."""
    from tvts_torch.models.configs import SortConfig, TextConfig, TVTSv2Config, VisionConfig

    return TVTSv2Config(
        name="dryrun",
        vision=VisionConfig(input_resolution=32, patch_size=16, width=64, layers=2, heads=4,
                            output_dim=64, num_frames=4, mask_ratio=0.5),
        text=TextConfig(context_length=16, vocab_size=128, width=64, layers=2, heads=4,
                        output_dim=64),
        sort=SortConfig(embed_dim=64, num_heads=4, num_classes=4))


def _worker(rank: int, n: int, port: int) -> None:
    """One rank of the dry run (module notes)."""
    from functools import partial

    from tvts_torch.models.tvts_v2 import TVTSv2
    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.parallel.mesh import create_mesh
    from tvts_torch.parallel.partition import shard_batch, shard_params
    from tvts_torch.train.optim import OptimizerConfig, make_optimizer
    from tvts_torch.train.step import make_train_step

    torch.set_num_threads(1)
    cfg = tiny_config()
    tp = 2 if n % 2 == 0 else 1
    fsdp = 2 if n % 8 == 0 else 1
    ocfg = OptimizerConfig(text_layers=cfg.text.layers, text_tune_layers=1, schedule=(6, 8),
                           steps_per_epoch=10)
    paths = {"eager": None, "kernels": partial(train_apply, text_tune_from=ocfg.text_tune_from)}
    losses = {}
    with create_mesh(fsdp=fsdp, tp=tp, coordinator=f"localhost:{port}", num_processes=n,
                     process_id=rank, device="cpu") as mesh:
        batch = shard_batch({k: torch.from_numpy(a) for k, a in _batch(cfg, 2 * n, 0).items()},
                            mesh)
        for label, apply_fn in paths.items():
            model = TVTSv2(cfg)
            model.reset_parameters(torch.Generator().manual_seed(0))
            shard_params(model, mesh)
            step = make_train_step(model, make_optimizer(model, ocfg), ocfg, apply_fn=apply_fn,
                                   mesh=mesh)
            losses[label] = step(batch)["loss"].item()
    jax = sorted(m for m in sys.modules if m.split(".")[0] in JAX_MODULES)
    print(f"[dryrun rank {rank}] dp {mesh.dp} x fsdp {mesh.fsdp} x tp {mesh.tp}: eager loss "
          f"{losses['eager']:.6f}, kernel path loss {losses['kernels']:.6f}; modules of JAX "
          f"loaded: {jax}", flush=True)
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"non-finite loss in the dry run: {losses}")
    if abs(losses["kernels"] - losses["eager"]) > LOSS_TOL:
        raise AssertionError(f"kernel path loss {losses['kernels']} != eager {losses['eager']}")


def dryrun_multichip(n: int) -> None:
    """The training step over `n` spawned gloo processes (module notes);
    raises if any fails."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_worker, args=(n, port), nprocs=n, join=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the dry run of __graft_entry__.py")
    ap.add_argument("n", type=int, nargs="?", default=None,
                    help="only the multi-process dry run, over n CPU processes")
    ap.add_argument("--device", default="cuda", help="entry's device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.n is None:
        fn, example = entry(args.device)
        with torch.no_grad():
            out = fn(*example)
        print("entry OK:", [tuple(o.shape) for o in out])
    dryrun_multichip(args.n or 8)
    print(f"dryrun_multichip OK ({args.n or 8} processes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
