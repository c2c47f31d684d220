"""Single-video feature extraction, the twin of
scripts/feature_extraction_TVTSv2.py (the reference's
v2/downstream/feature_extraction_TVTSv2_*.py).

    python -m tvts_torch.cli.feature_extraction --arch TVTSv2_B_16 \\
        --load_checkpoint TVTSv2_ViT_B_16.pth --video_path demo.mp4 [--fused] [--out emb.npy]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tvts_torch.eval.feature_extraction import extract_video_feature
from tvts_torch.models.configs import MODEL_REGISTRY
from tvts_torch.models.factory import build_model


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="TVTSv2_B_16", choices=sorted(MODEL_REGISTRY))
    ap.add_argument("--video_path", required=True)
    ap.add_argument("--load_checkpoint", default=None)
    ap.add_argument("--out", default=None, help="save the embedding to .npy")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--fused", action="store_true", help="the video tower on the kernels")
    ap.add_argument("--fast_pipeline", action="store_true",
                    help="decoder-side resize and normalisation on the device")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    _, model = build_model(args.arch, load_checkpoint=args.load_checkpoint, eval_mode=True,
                           dtype=torch.bfloat16 if args.bf16 else torch.float32,
                           device=args.device)
    emb = extract_video_feature(model, args.video_path, use_fused=args.fused,
                                fast_pipeline=args.fast_pipeline)
    print(f"video embedding shape: {emb.shape}")
    print(emb[0, :8])
    if args.out:
        np.save(args.out, emb)
    return emb


if __name__ == "__main__":
    main()
