"""Zero-shot text <-> video retrieval (counterpart of tvts_tpu/eval/zero_ret.py):
embeddings -> optional sliding-window mean-pool -> cosine sims -> t2v / v2t
metrics. No pandas."""

from __future__ import annotations

import numpy as np
import torch

from tvts_torch.eval.embed import extract_embeddings, verbose
from tvts_torch.ops import metrics as metrics_mod
from tvts_torch.ops.sim import sim_matrix


def sliding_window_meanpool(vid_embeds, text_embeds, metas):
    """Mean-pool the window embeddings of each video (videos in order of first
    appearance) and keep one text embedding per unique caption of each video.
    As in the JAX package, the text row kept for a caption is its first row
    in the WHOLE table, not the first within that video."""
    videoids = [m["paths"] for m in metas]
    caps = [str(m["raw_captions"]) for m in metas]
    first_row = {}
    for i, cap in enumerate(caps):
        first_row.setdefault(cap, i)
    new_vid, new_txt = [], []
    for vid in dict.fromkeys(videoids):
        rows = [i for i, v in enumerate(videoids) if v == vid]
        new_vid.append(np.stack([vid_embeds[i] for i in rows]).mean(axis=0))
        for cap in dict.fromkeys(caps[i] for i in rows):
            new_txt.append(text_embeds[first_row[cap]])
    return np.stack(new_vid), np.stack(new_txt)


def run_retrieval(model, loader, metric_names=("t2v_metrics", "v2t_metrics"),
                  sliding_window: bool = False, context_length: int = 77,
                  use_fused: bool = False):
    """(metrics by name, sims [num_captions, num_videos] float32)."""
    out = extract_embeddings(model, loader, context_length=context_length,
                             use_fused=use_fused)
    vid, txt = out["video"], out["text"]
    if sliding_window:
        vid, txt = sliding_window_meanpool(vid, txt, out["metas"])
    sims = sim_matrix(torch.from_numpy(txt), torch.from_numpy(vid)).numpy()
    nested = {}
    for name in metric_names:
        res = getattr(metrics_mod, name)(sims)
        verbose(epoch=0, metrics=res, name="", mode=name)
        nested[name] = res
    return nested, sims
