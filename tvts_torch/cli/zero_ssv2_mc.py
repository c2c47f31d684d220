"""SSV2 multiple-choice zero-shot eval, the twin of scripts/zero_ssv2_mc_TVTSv2.py
(the reference's v2/downstream/zero_ssv2_mc_TVTSv2_ViT_*.py). The towers run
eager, as in the JAX script.

    python -m tvts_torch.cli.zero_ssv2_mc -c tvts_tpu/configs/zero-ssv2-mc-vit-b-16.json
"""

from __future__ import annotations

import argparse

import torch

from tvts_torch.eval.zero_ssv2_mc import run_ssv2_mc
from tvts_torch.models.factory import build_model
from tvts_torch.utils.config import ConfigParser, read_json


def main(argv=None) -> dict:
    """Returns run_ssv2_mc's result (accuracy, correct, total)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--load_checkpoint", default=None)
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    config = ConfigParser(read_json(args.config), test=True)
    ckpt = args.load_checkpoint or config["arch"]["args"].get("load_checkpoint")
    cfg, model = build_model(config["arch"]["type"], load_checkpoint=ckpt, eval_mode=True,
                             dtype=torch.bfloat16 if args.bf16 else torch.float32,
                             device=args.device)

    _, loader = config.initialize_dataset_loader(config["data_loader"],
                                                 {"split": "test", "shuffle": False})
    return run_ssv2_mc(model, loader, context_length=cfg.text.context_length)


if __name__ == "__main__":
    main()
