"""benchmark/flops.py against counts made by hand, one product at a time."""

from __future__ import annotations

import json

import pytest

from benchmark import flops
from benchmark.tests.conftest import ROOT


def _b16():
    return json.loads((ROOT / "benchmark/configs/tvtsv2_b16.json").read_text())


def test_one_video_block_by_hand():
    """A B/16 extraction block at 12 x 196 patches: 2 flops a multiply-add."""
    v = dict(_b16()["vision"], layers=1)
    D, T, N = 768, 12, 196
    S = 1 + T * N
    qkv, proj, fc, out = 2 * S * D * 3 * D, 2 * S * D * D, 2 * S * D * 4 * D, 2 * S * 4 * D * D
    products = 2 * (qkv + proj) + fc + out
    # a query over its keys: q.k and p.v, 2 d flops each, summed over the heads: 4 D a pair
    time_pairs = T * N * (1 + T) + S   # each patch over the CLS key and its T frames; CLS over all
    space_pairs = T * N * (1 + N) + S  # each patch over the CLS key and its frame; CLS over all
    cores = 4 * D * (time_pairs + space_pairs)
    pool = 2 * S * D * 512
    stem = 2 * (3 * 16 * 16) * D * T * N
    assert flops.video_forward(v, N, cls_only_last=False) == (products + pool, cores, stem)


def test_cls_only_last_block_by_hand():
    v = dict(_b16()["vision"], layers=1)
    D, T, N = 768, 12, 196
    S = 1 + T * N
    time_sub = 2 * S * D * 3 * D + 2 * S * D * D
    space_cls = 2 * D * D + 2 * S * D * 2 * D + 2 * D * D  # q of the CLS row, k and v of all, proj
    mlp_cls = 2 * D * 4 * D * 2
    products, cores, _ = flops.video_forward(v, N, cls_only_last=True)
    assert products == time_sub + space_cls + mlp_cls + 2 * D * 512
    assert cores == 4 * D * (T * N * (1 + T) + S) + 4 * D * S


def test_training_counts_backward_twice_and_frozen_once():
    cfg = _b16()
    t = cfg["text"]
    one = flops.train_flops_per_clip(cfg, 98, 1, frozen_text=0)
    all_frozen = flops.train_flops_per_clip(cfg, 98, 1, frozen_text=t["layers"])
    text_products = sum(p for p, _ in flops.text_forward(t))
    assert one - all_frozen == pytest.approx(text_products)


def test_bound_is_the_larger_of_operations_and_bytes():
    assert flops.bound_ms(989e9, 0) == pytest.approx(1.0)
    assert flops.bound_ms(0, 3.35e9) == pytest.approx(1.0)
    assert flops.bound_ms(989e9, 6.7e9) == pytest.approx(2.0)


def test_attention_sub_path_work():
    """H1 at B = 1, T = 2, N = 3, D = 8: the products of its qkv and proj rows
    and the core's pairs; bytes: x read and the output written (bf16), the
    weights read."""
    B, T, N, D, H = 1, 2, 3, 8, 2
    S = 7
    ops, nbytes = flops.attention_work("time", B, T, N, D, H, backward=False)
    assert ops == 2 * S * D * 3 * D + 2 * S * D * D + 4 * D * (T * N * (T + 1) + S)
    assert nbytes == 4 * S * D + 2 * 4 * D * D
