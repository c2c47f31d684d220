"""Shared set-up of the benchmark's CPU tests: a tiny TVTSv2 configuration
with the published structure (divided space-time blocks, the text tower over
the CLIP id range, the sort head) and the cells of BENCHMARK.json cut to it."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {
    "name": "tiny", "arch": "TVTSv2_B_16",
    "vision": {"input_resolution": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 2,
               "output_dim": 32, "num_frames": 2, "mask_ratio": 0.5, "mlp_ratio": 4.0,
               "act": "quick_gelu", "pool_style": "openai"},
    "text": {"context_length": 8, "vocab_size": 49408, "width": 64, "layers": 3, "heads": 2,
             "output_dim": 32, "act": "quick_gelu"},
    "sort": {"embed_dim": 32, "depth": 2, "num_heads": 2, "num_classes": 4, "mlp_ratio": 4.0},
    "num_clips": 4,
}
# the tiny configuration's limits, from its CPU readings on three seeds: the bf16
# program reads pooled 0.008; loss 3e-4, embeddings 0.011, gradient 0.0125,
# change 0.017; the fp8 control pooled 0.088; loss 0.013-0.073, embeddings
# 0.098-0.112, gradient 0.15-0.22, change 0.039-0.093
TINY_LIMITS = {"b16.extract": {"pooled_err": 0.03},
               "b16.pretrain": {"loss_gap": 0.012, "emb_err": 0.035, "grad_gap": 0.06,
                                "change_gap": 0.04, "frozen_moved": 0}}


# The pretraining cell that BENCHMARK.json leaves out (PERF.md, Open questions:
# at the published 12 clips a card the step is host bound and its runs spread
# too widely to bound), as the files and entries that add it: the mix of
# TVTSv2's dist-yt-web-pt-vit-b-16-fused.json and the metrics only it reports.
# The tests run it at the tiny size through traffic/pretrain.py.
PRETRAIN_MIX = {
    "kind": "pretrain", "batch": 12, "pool": 4,
    "rounds": [{"name": "yt_temporal", "captions": 4, "sort_labels": True},
               {"name": "webvid", "captions": 1, "sort_labels": False}],
    "caption_tokens": [5, 77], "truncated_share": 0.1, "text_tune_layers": 3,
    "optimizer": {"lr_new": 1e-4, "lr_clip": 1e-7, "weight_decay": 0.05,
                  "betas": [0.9, 0.999], "eps": 1e-6},
    "kernels": {"fused": True, "preset": "best"}, "checked_steps": 3,
    "subpaths": ["time_subpath", "space_subpath", "text_subpath", "_TimeSubpath.backward",
                 "_SpaceSubpath.backward", "_TextSubpath.backward"],
}
PRETRAIN_CELL = {"name": "b16.pretrain", "config": "tvtsv2_b16", "traffic": "pretrain_b12",
                 "chips": 1, "why": "the pretraining step at the published 12 clips a card"}
PRETRAIN_METRICS = {
    "end_to_end": [{"name": "peak_mem_gib", "unit": "GiB", "better": "lower", "bound": 0.01,
                    "source": "device_trace"}],
    "per_layer": [{"name": name, "unit": "ms", "better": "lower", "source": "program_span",
                   "layer": layer, "moves": "clips_per_s"}
                  for name, layer in (("fwd_ms", "ops.fused_forward (train_apply)"),
                                      ("bwd_ms", "autograd through ops.block_backward"),
                                      ("opt_ms", "train.optim (AdamW, the bf16 casts)"))],
}


@pytest.fixture
def spec(tmp_path) -> dict:
    """BENCHMARK.json with every configuration replaced by TINY, and the
    pretraining cell with its metrics added."""
    out = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "tiny.json").write_text(json.dumps(TINY))
    for config in out["configs"]:
        config["file"] = str(tmp_path / "tiny.json")
    out["workloads"].append(PRETRAIN_CELL)
    for entry in out["per_layer"]:  # every per-layer metric so far reads in it too
        entry["workloads"].append(PRETRAIN_CELL["name"])
    for kind, entries in PRETRAIN_METRICS.items():
        for entry in entries:
            out[kind].append(dict(entry, workloads=[PRETRAIN_CELL["name"]]))
    return out


@pytest.fixture
def bench(tmp_path) -> Path:
    """A copy of benchmark/ with the pretraining cell's mix and limits added."""
    out = tmp_path / "bench"
    shutil.copytree(ROOT / "benchmark", out, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (out / "traffic" / f"{PRETRAIN_CELL['traffic']}.json").write_text(json.dumps(PRETRAIN_MIX))
    (out / "limits" / f"{PRETRAIN_CELL['name']}.json").write_text(
        json.dumps(TINY_LIMITS[PRETRAIN_CELL["name"]]))
    return out


def tiny_cell(spec: dict, bench: Path, name: str):
    """A cell of `spec` at the tiny size: batch 4, captions of 3-8 tokens."""
    from benchmark import harness

    cell = harness.Cell(spec, name, bench_dir=bench)
    cell.traffic = dict(cell.traffic, batch=4, reference_chunk=2, caption_tokens=[3, 8])
    cell.limits = TINY_LIMITS[name]
    return cell


@pytest.fixture
def card():
    """Skips unless a CUDA device is present (decided here, not at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
