"""Zero-shot text <-> video retrieval, the twin of scripts/zero_ret_TVTSv2.py
(the reference's v2/downstream/zero_ret_TVTSv2_ViT_*.py).

    python -m tvts_torch.cli.zero_ret -c tvts_tpu/configs/zero-msrvtt-vit-b-16.json [--fused]
"""

from __future__ import annotations

import argparse

import torch

from tvts_torch.eval.zero_ret import run_retrieval
from tvts_torch.models.factory import build_model
from tvts_torch.utils.config import ConfigParser, read_json


def main(argv=None):
    """Returns run_retrieval's (metrics by name, similarity matrix)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--sliding_window_stride", type=int, default=-1)
    ap.add_argument("--load_checkpoint", default=None)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--fused", action="store_true", help="both towers on the kernels")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    config = ConfigParser(read_json(args.config), test=True)
    ckpt = args.load_checkpoint or config["arch"]["args"].get("load_checkpoint")
    cfg, model = build_model(config["arch"]["type"], load_checkpoint=ckpt, eval_mode=True,
                             dtype=torch.bfloat16 if args.bf16 else torch.float32,
                             device=args.device)

    overrides = {"split": "test", "shuffle": False}
    if args.sliding_window_stride != -1:
        overrides["sliding_window_stride"] = args.sliding_window_stride
    _, loader = config.initialize_dataset_loader(config["data_loader"], overrides)

    return run_retrieval(model, loader,
                         metric_names=tuple(config.get("metrics",
                                                       ["t2v_metrics", "v2t_metrics"])),
                         sliding_window=args.sliding_window_stride != -1,
                         context_length=cfg.text.context_length, use_fused=args.fused)


if __name__ == "__main__":
    main()
