"""Zero-shot action recognition, the twin of scripts/zero_recognition_TVTSv2.py
(the reference's v2/downstream/zero_recognition_TVTSv2_ViT_*.py): an
'a person {}' prompt classifier over meta_data/<dataset>/prompt/label2id.json.
The towers run eager, as in the JAX script.

    python -m tvts_torch.cli.zero_recognition -c tvts_tpu/configs/zero-ucf101-vit-b-16.json
"""

from __future__ import annotations

import argparse
import os

import torch

from tvts_torch.eval.zero_recognition import load_label2id, run_recognition
from tvts_torch.models.factory import build_model
from tvts_torch.utils.config import ConfigParser, read_json


def main(argv=None) -> dict:
    """Returns run_recognition's result (top1, top5, logits)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("--dataset", default=None, choices=[None, "ucf101", "hmdb51", "k400"])
    ap.add_argument("--load_checkpoint", default=None)
    ap.add_argument("--meta_root", default="meta_data")
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

    ds = args.dataset or config["data_loader"]["args"]["dataset_name"].lower()
    ds = {"kinetics400": "k400"}.get(ds, ds)
    label2id = load_label2id(os.path.join(args.meta_root, ds, "prompt", "label2id.json"))
    # the classifier's columns in the json's key order, as the reference
    # (zero_recognition_...py:62-64: list(label2id.keys()))
    return run_recognition(model, loader, list(label2id.keys()),
                           context_length=cfg.text.context_length)


if __name__ == "__main__":
    main()
