"""Embedding-extraction loop shared by the zero-shot evals (counterpart of
tvts_tpu/eval/embed.py): tokenize (truncating) -> model -> collect the text
and video embeddings, plus labels and metas.

Batches (clips and token ids) are padded to the loader's fixed batch size by
repeating the last row and the pad rows are trimmed after the forward, as in
the JAX package (there it keeps one compiled graph; here one set of kernel
shapes).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from tvts_torch.ops.fused_forward import space_time_vit_fused_forward
from tvts_torch.ops.text_attention import text_transformer_fused_forward
from tvts_torch.text.tokenizer import tokenize_openclip

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


def make_embed_fns(model, use_fused: bool = False, **tpu_knobs):
    """(embed_text, embed_video) for a TVTSv2. use_fused=True runs both towers
    through the kernels (text: H7, EOT-only last block; video: H1-H4,
    CLS-only last block); use_fused=False the eager modules. The kernels do
    not read LayerScale gammas, so the video tower of such a config stays
    eager, as in the JAX package.
    embed_text(ids [N, ctx]) -> [N, out]; embed_video(video, keep) -> pooled."""
    unknown = set(tpu_knobs) - set(TPU_SCHEDULE_KNOBS)
    if unknown:
        raise TypeError(f"unknown arguments {sorted(unknown)}")
    if tpu_knobs:
        log.warning("ignoring TPU schedule knobs %s: the Hopper kernels choose "
                    "their own tiling", sorted(tpu_knobs))
    fused_video = use_fused and model.video_model.cfg.ls_init is None

    @torch.inference_mode()
    def embed_text(ids: torch.Tensor) -> torch.Tensor:
        if use_fused:
            return text_transformer_fused_forward(model, ids)
        return model.compute_text(ids)

    @torch.inference_mode()
    def embed_video(video: torch.Tensor, keep: torch.Tensor | None) -> torch.Tensor:
        if fused_video:
            pooled, _ = space_time_vit_fused_forward(model.video_model, video, keep,
                                                     need_tokens=False)
        else:
            pooled, _ = model.compute_video(video, keep)
        return pooled

    return embed_text, embed_video


def _device(model) -> torch.device:
    return next(model.parameters()).device


def embed_texts(embed_text, texts, device, context_length: int = 77,
                batch_size: int | None = None) -> np.ndarray:
    """Tokenize (open_clip convention), pad the ids to `batch_size` rows, embed,
    trim: [len(texts), out] float32."""
    ids = tokenize_openclip(texts, context_length=context_length)
    if batch_size is not None:
        ids = _pad_to(ids, batch_size)
    out = embed_text(torch.from_numpy(ids).to(device))
    return out.float().cpu().numpy()[:len(texts)]


def extract_embeddings(model, loader, with_text: bool = True, context_length: int = 77,
                       use_fused: bool = False, **tpu_knobs) -> dict:
    """Iterate a test loader; returns 'video' [N, out] (float32 numpy), plus
    'text' [N, out] when with_text and the batches carry caption strings, and
    'labels' and 'metas' when present."""
    embed_text, embed_video = make_embed_fns(model, use_fused=use_fused, **tpu_knobs)
    device = _device(model)
    batch_size = loader.batch_size

    vid_out, txt_out, labels, metas = [], [], [], []
    for batch in loader:
        n = batch["video"].shape[0]
        video = _pad_to(np.asarray(batch["video"], np.float32), batch_size)
        keep = _pad_to(np.asarray(batch["keep_ind"], np.int64), batch_size)
        v = embed_video(torch.from_numpy(video).to(device), torch.from_numpy(keep).to(device))
        vid_out.append(v.float().cpu().numpy()[:n])
        text = batch.get("text")
        if with_text and isinstance(text, list) and text and isinstance(text[0], str):
            txt_out.append(embed_texts(embed_text, text, device, context_length, batch_size))
        if "label" in batch:
            labels.extend(np.asarray(batch["label"]).tolist())
        if "meta" in batch:
            metas.extend(batch["meta"])

    out = {"video": np.concatenate(vid_out)}
    if txt_out:
        out["text"] = np.concatenate(txt_out)
    if labels:
        out["labels"] = np.asarray(labels)
    if metas:
        out["metas"] = metas
    return out


def verbose(epoch: int, metrics: dict, name: str = "", mode: str = "t2v_metrics") -> str:
    """Retrieval metric pretty-printer (reference trainer.py:942-947)."""
    r1, r5, r10, r50 = metrics["R1"], metrics["R5"], metrics["R10"], metrics["R50"]
    msg = f"[{mode}]{name:s} epoch {epoch}, R@1: {r1:.1f}"
    msg += f", R@5: {r5:.1f}, R@10 {r10:.1f}, R@50 {r50:.1f}"
    msg += f"MedR: {metrics['MedR']:g}, MeanR: {metrics['MeanR']:.1f}"
    print(msg)
    return msg
