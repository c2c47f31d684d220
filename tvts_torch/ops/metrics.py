"""Retrieval metrics (counterpart of tvts_tpu/ops/metrics.py), numpy + scipy.

Rank semantics of the reference, ties included:
- `t2v_metrics` breaks ties optimistically: the rank of the ground truth is
  the count of strictly smaller distances in its row;
- `v2t_metrics` averages ties, rank = (#smaller) + (#equal - 1) / 2, takes the
  best-ranked ground-truth caption per video, and gives masked captions the
  distance 1e8;
- `retrieval_as_classification` averages ties and subtracts the enumeration
  index of each ground-truth label (ascending label order).
The classification and alignment metrics the Trainer may name (`acc`,
`topk_acc`, `video_precision`, `video_precision_adj`) follow.
"""

from __future__ import annotations

import numpy as np
import scipy.stats

MISSING_VAL = 1e8


def cols2metrics(cols: np.ndarray, num_queries: int) -> dict:
    cols = np.asarray(cols)
    metrics = {
        "R1": 100 * float(np.sum(cols == 0)) / num_queries,
        "R5": 100 * float(np.sum(cols < 5)) / num_queries,
        "R10": 100 * float(np.sum(cols < 10)) / num_queries,
        "R50": 100 * float(np.sum(cols < 50)) / num_queries,
        "MedR": float(np.median(cols) + 1),
        "MeanR": float(np.mean(cols) + 1),
    }
    stats = [metrics[x] for x in ("R1", "R5", "R10")]
    metrics["geometric_mean_R1-R5-R10"] = float(scipy.stats.mstats.gmean(stats))
    return metrics


def t2v_metrics(sims: np.ndarray, query_masks: np.ndarray | None = None) -> dict:
    """sims [num_queries, num_vids]; query i's ground truth is video i // (N / M)."""
    dists = -np.asarray(sims)
    if dists.ndim != 2:
        raise ValueError("expected a matrix")
    num_queries, num_vids = dists.shape
    gt_vid = np.arange(num_queries) // (num_queries // num_vids)
    cols = np.sum(dists < dists[np.arange(num_queries), gt_vid][:, None], axis=1)
    if query_masks is not None:
        if query_masks.size != num_queries:
            raise ValueError("invalid query mask shape")
        cols = cols[query_masks.reshape(-1).astype(bool)]
        num_queries = int(query_masks.sum())
    return cols2metrics(cols, num_queries)


def _averaged_rank(row: np.ndarray, val: float) -> float:
    return np.sum(row < val) + (np.sum(row == val) - 1) / 2.0


def v2t_metrics(sims: np.ndarray, query_masks: np.ndarray | None = None) -> dict:
    """sims [num_caps, num_vids], the orientation of t2v (transposed inside)."""
    dists = -np.asarray(sims).T.copy()  # [num_vids, num_caps]
    num_queries, num_caps = dists.shape
    caps_per_video = num_caps // num_queries
    if query_masks is not None:
        dists[:, ~query_masks.reshape(-1).astype(bool)] = MISSING_VAL
    ranks = np.empty(num_queries)
    for ii in range(num_queries):
        row = dists[ii]
        gt = row[ii * caps_per_video:(ii + 1) * caps_per_video]
        ranks[ii] = min((_averaged_rank(row, v) for v in gt if v != MISSING_VAL),
                        default=np.inf)
    return cols2metrics(ranks, num_queries)


def retrieval_as_classification(sims: np.ndarray, query_masks: np.ndarray) -> dict:
    """sims [num_labels, num_videos]; query_masks marks each video's gt labels."""
    dists = -np.asarray(sims).T  # [num_videos, num_labels]
    masks = np.asarray(query_masks).T
    ranks = []
    for row, mask in zip(dists, masks):
        ranks.extend(_averaged_rank(row, row[label]) - idx
                     for idx, label in enumerate(np.flatnonzero(mask)))
    return cols2metrics(np.asarray(ranks), num_queries=len(ranks))


def acc(output: np.ndarray, target: np.ndarray) -> float:
    """Top-1 accuracy."""
    pred = np.argmax(np.asarray(output), axis=1)
    target = np.asarray(target)
    if pred.shape[0] != len(target):
        raise ValueError(f"{pred.shape[0]} predictions for {len(target)} targets")
    return float(np.sum(pred == target)) / len(target)


def topk_acc(output: np.ndarray, target: np.ndarray, k: int = 5) -> float:
    """Top-k accuracy; equal scores rank in column order."""
    topk = np.argsort(-np.asarray(output), axis=1, kind="stable")[:, :k]
    target = np.asarray(target)
    return float(np.sum(topk == target[:, None])) / len(target)


def _pair_matches(output: np.ndarray, target: np.ndarray) -> int:
    """Predicted (video, text) id pairs [B, P, 2] that appear, both ids, among
    the same batch element's target pairs [B, P', 2]."""
    output, target = np.asarray(output), np.asarray(target)
    if output.shape[0] != target.shape[0] or output.shape[2] != 2 or target.shape[2] != 2:
        raise ValueError(f"pairs {output.shape} and {target.shape}: expected [B, P, 2] each")
    return int((output[:, :, None, :] == target[:, None, :, :]).all(-1).any(-1).sum())


def video_precision(output: np.ndarray, target: np.ndarray) -> float:
    """Fraction of predicted pairs aligned to a target pair."""
    target = np.asarray(target)
    return _pair_matches(output, target) / (target.shape[0] * target.shape[1])


def video_precision_adj(output: np.ndarray, target: np.ndarray) -> float:
    """video_precision over the videos that have an aligning text: the
    denominator is the number of distinct video ids in target[:, :, 0]."""
    target = np.asarray(target)
    return _pair_matches(output, target) / len(np.unique(target[:, :, 0]))
