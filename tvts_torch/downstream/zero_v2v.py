"""Zero-shot video-to-video retrieval (counterpart of
tvts_tpu/downstream/zero_v2v.py; reference v1/downstream/run_class_zero.py:345-414):
every validation clip embedded by the pretrained video tower's CLS row (no
classifier), a self-masked cosine similarity matrix (the diagonal at -1000),
and a query's rank the first of its top 10 retrieved clips that shares its
label; R@1/5/10. The metric is numpy, ties broken as np.argsort breaks them.
"""

from __future__ import annotations

import numpy as np
import torch


def v2v_retrieval_metrics(feats: np.ndarray, labels: np.ndarray,
                          recall_k: int = 10) -> dict:
    feats = np.asarray(feats, dtype=np.float32)
    labels = np.asarray(labels)
    norm = np.linalg.norm(feats, axis=1, keepdims=True)
    f = feats / np.maximum(norm, 1e-8)
    scores = f @ f.T
    np.fill_diagonal(scores, -1000.0)

    same = labels[:, None] == labels[None, :]
    ix = np.argsort(-scores, axis=1)
    n = len(labels)
    ranks = np.full(n, 1e20)
    for q in range(n):
        for r in range(recall_k):
            if same[q, ix[q, r]]:
                ranks[q] = r
                break
    return {
        "R1": 100.0 * float(np.sum(ranks < 1)) / n,
        "R5": 100.0 * float(np.sum(ranks < 5)) / n,
        "R10": 100.0 * float(np.sum(ranks < 10)) / n,
    }


def run_zero_v2v(model, loader, device) -> tuple[dict, np.ndarray, np.ndarray]:
    """Embed every clip of `loader` with the headless tower (JointViT: its CLS
    row after the final norm) on `device` and score v2v retrieval; prints
    R@1/5/10 as the JAX function does. Returns (metrics, features [N, D]
    float32, labels)."""
    feats, labels = [], []
    with torch.inference_mode():
        for batch in loader:
            tokens = model(torch.from_numpy(np.asarray(batch["video"])).to(device))
            feats.append((tokens[:, 0] if tokens.ndim == 3 else tokens).float().cpu().numpy())
            labels.extend(np.asarray(batch["label"]).tolist())
    feats, labels = np.concatenate(feats), np.asarray(labels)
    res = v2v_retrieval_metrics(feats, labels)
    print(f"R@1: {res['R1']}\nR@5: {res['R5']}\nR@10: {res['R10']}")
    return res, feats, labels
