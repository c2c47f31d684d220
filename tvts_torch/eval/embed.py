"""Embedding-extraction loop (counterpart of tvts_tpu/eval/embed.py), video side.

Batches are padded to the loader's fixed batch size by repeating the last row
and the pad rows are trimmed after the forward, as in the JAX package (there it
keeps one compiled graph; here it keeps one set of kernel shapes). The text
tower arrives with slice 2.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tvts_torch.ops.fused_forward import space_time_vit_fused_forward

log = logging.getLogger(__name__)

# Schedule knobs of the TPU kernels (tvts_tpu eval/embed.py, ops/fused_forward.py).
# The Hopper kernels choose their own tiling, so they are accepted and ignored.
TPU_SCHEDULE_KNOBS = ("kernel_version", "space_fpp", "mm_group", "mlp_group",
                      "time_chunk", "scan_blocks", "smv")


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    if arr.shape[0] == n:
        return arr
    pad = np.repeat(arr[-1:], n - arr.shape[0], axis=0)
    return np.concatenate([arr, pad], axis=0)


def _embed_text(*_args, **_kwargs):
    raise NotImplementedError("text tower: slice 2")


def make_embed_fns(model, use_fused: bool = False, **tpu_knobs):
    """(embed_text, embed_video) for a SpaceTimeViT. use_fused=True runs the
    sub-path kernels (ops/fused_forward.py, CLS-only last block);
    use_fused=False the eager module. embed_video(video, keep) -> pooled."""
    unknown = set(tpu_knobs) - set(TPU_SCHEDULE_KNOBS)
    if unknown:
        raise TypeError(f"unknown arguments {sorted(unknown)}")
    if tpu_knobs:
        log.warning("ignoring TPU schedule knobs %s: the Hopper kernels choose "
                    "their own tiling", sorted(tpu_knobs))

    @torch.inference_mode()
    def embed_video(video: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
        if use_fused:
            pooled, _ = space_time_vit_fused_forward(model, video, keep, need_tokens=False)
        else:
            pooled, _ = model(video, keep)
        return pooled

    return _embed_text, embed_video


def extract_embeddings(model, loader, with_text: bool = False, use_fused: bool = False,
                       **tpu_knobs) -> dict:
    """Iterate a test loader; returns 'video' [N, out] (float32 numpy), plus
    'labels' and 'metas' when present."""
    if with_text:
        raise NotImplementedError("text tower: slice 2")
    _, embed_video = make_embed_fns(model, use_fused=use_fused, **tpu_knobs)
    device = next(model.parameters()).device
    batch_size = loader.batch_size

    vid_out, labels, metas = [], [], []
    for batch in loader:
        n = batch["video"].shape[0]
        video = _pad_to(np.asarray(batch["video"], np.float32), batch_size)
        keep = _pad_to(np.asarray(batch["keep_ind"], np.int64), batch_size)
        v = embed_video(torch.from_numpy(video).to(device),
                        torch.from_numpy(keep).to(device))
        vid_out.append(v.float().cpu().numpy()[:n])
        if "label" in batch:
            labels.extend(np.asarray(batch["label"]).tolist())
        if "meta" in batch:
            metas.extend(batch["meta"])

    out = {"video": np.concatenate(vid_out)}
    if labels:
        out["labels"] = np.asarray(labels)
    if metas:
        out["metas"] = metas
    return out
