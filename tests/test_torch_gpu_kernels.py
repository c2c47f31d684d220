"""The Hopper kernels (H1-H4 sub-paths of the video tower, H7 text attention,
and the H5 / H6 / H7 training backwards) against their plain PyTorch versions,
on the card in bf16, with chip_smoke.py's seeded inputs and bands; and a small
train step, kernel path against eager. Marked `gpu`: they skip where no CUDA
device is present.

Run on an H100 (tests/conftest.py imports jax, which the port does not need):
    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu_kernels.py -q

Tolerance: max|diff| <= 0.05 * max(1, mean|ref| / 0.8), the band the Pallas
kernels hold against XLA in bf16 (max|diff| 0.031-0.047 at mean|out| ~0.8);
each gradient tensor within 0.06 * max|ref| (the TPU's real-shape gradient
band, 5.8e-2).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (
    BWD_SHAPES,
    GRAD_NAMES,
    TEXT_BWD_SHAPES,
    TEXT_SHAPES,
    backward_calls,
    band_check,
    grad_band_check,
    kernel_calls,
    seeded_inputs,
    text_backward_calls,
    text_calls,
    text_inputs,
)
from tvts_torch.ops import block_backward as bb
from tvts_torch.ops import block_kernels as bk
from tvts_torch.ops import text_attention as ta

pytestmark = pytest.mark.gpu

# (B, T, N, D, H, act): B/16 extraction, B/32's N=49, H/14's width and head dim 80
SHAPES = [(2, 12, 196, 768, 12, "quick_gelu"), (1, 12, 49, 768, 12, "quick_gelu"),
          (1, 4, 256, 1280, 16, "gelu")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", [fn.__name__ for fn in bk.KERNELS])
def test_kernel_matches_plain(cuda, shape, name):
    B, T, N, D, H, act = shape
    kernel, plain = kernel_calls(bk, seeded_inputs(B, T, N, D, 0, cuda), T, H, act)[name]
    before = getattr(bk, name).launches
    got = kernel()
    assert getattr(bk, name).launches == before + 1
    torch.cuda.synchronize()
    want = plain()
    assert got.shape == want.shape
    diff, ref, tol = band_check(got, want)
    assert diff <= tol, (diff, ref)


def test_mlp_kernel_other_activation(cuda):
    B, T, N, D, H, _ = SHAPES[0]
    kernel, plain = kernel_calls(bk, seeded_inputs(B, T, N, D, 1, cuda), T, H,
                                 "gelu")["fused_mlp_block"]
    diff, ref, tol = band_check(kernel(), plain())
    assert diff <= tol, (diff, ref)


def test_cls_only_kernel_is_row_zero_of_space_kernel(cuda):
    B, T, N, D, H, act = SHAPES[0]
    calls = kernel_calls(bk, seeded_inputs(B, T, N, D, 2, cuda), T, H, act)
    full = calls["fused_space_block"][0]()
    cls = calls["fused_space_cls_only"][0]()
    diff, ref, tol = band_check(cls, full[:, :1])
    assert diff <= tol, (diff, ref)


def test_kernels_raise_on_what_they_do_not_take(cuda):
    T = 4
    a = seeded_inputs(1, T, 16, 256, 3, cuda)
    w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
    with pytest.raises(ValueError, match="head dim"):
        bk.fused_time_block(a["x"], *w, num_frames=T, num_heads=8)  # head dim 32
    with pytest.raises(TypeError):
        bk.fused_time_block(a["x"].float(), *w, num_frames=T, num_heads=4)
    with pytest.raises(ValueError, match="contiguous"):
        strided = a["x"].transpose(1, 2).contiguous().transpose(1, 2)  # same shape
        bk.fused_time_block(strided, *w, num_frames=T, num_heads=4)


def test_fused_forward_matches_eager_on_card(cuda):
    from tvts_torch.models.configs import VisionConfig
    from tvts_torch.models.factory import cast_tower_
    from tvts_torch.models.space_time_vit import SpaceTimeViT
    from tvts_torch.ops.fused_forward import space_time_vit_fused_forward

    cfg = VisionConfig(input_resolution=64, patch_size=16, width=128, layers=2, heads=2,
                       output_dim=64, num_frames=4, mask_ratio=0.0)
    model = SpaceTimeViT(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    with torch.no_grad():  # noise on every leaf: the time attention is zero at init
        for p in model.parameters():
            p.add_(torch.from_numpy(0.02 * rng.standard_normal(p.shape).astype(np.float32)))
    model = cast_tower_(model, torch.bfloat16).to(cuda)
    video = torch.tensor(rng.standard_normal((3, 4, 3, 64, 64)), dtype=torch.float32,
                         device=cuda)
    with torch.no_grad():
        want, _ = model(video)
        got, tokens = space_time_vit_fused_forward(model, video, need_tokens=False)
        full, _ = space_time_vit_fused_forward(model, video)
    assert tokens is None
    for out in (got, full):
        cos = torch.nn.functional.cosine_similarity(out.float(), want.float(), dim=-1)
        assert cos.min().item() >= 0.999, cos


@pytest.mark.parametrize("label", list(TEXT_SHAPES))
def test_text_kernel_matches_plain(cuda, label):
    B, S, D, H, causal, eps = TEXT_SHAPES[label]
    kernel, plain = text_calls(ta, text_inputs(B, S, D, 0, cuda), H, causal, eps)
    before = ta.fused_text_attention_block.launches
    got = kernel()
    assert ta.fused_text_attention_block.launches == before + 1
    torch.cuda.synchronize()
    want = plain()
    assert got.shape == want.shape
    diff, ref, tol = band_check(got, want)
    assert diff <= tol, (diff, ref)


def test_text_kernel_is_causal_and_takes_head_dim_64_only(cuda):
    B, S, D, H, _, eps = TEXT_SHAPES["B/16 text"]
    a = text_inputs(B, S, D, 1, cuda)
    out = text_calls(ta, a, H, True, eps)[0]()
    a["x"][:, 40:] = 0  # rows after 39 must not reach rows up to 39
    cut = text_calls(ta, a, H, True, eps)[0]()
    assert torch.equal(out[:, :40], cut[:, :40])
    w = (a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"], a["wproj"], a["bproj"])
    with pytest.raises(ValueError, match="head dim 64"):
        ta.fused_text_attention_block(a["x"], *w, num_heads=4)  # head dim 128
    with pytest.raises(TypeError):
        ta.fused_text_attention_block(a["x"].float(), *w, num_heads=H)


def test_text_fused_forward_matches_eager_on_card(cuda):
    from tvts_torch.models.configs import TextConfig
    from tvts_torch.models.factory import cast_tower_
    from tvts_torch.models.text import TextTransformer
    from tvts_torch.ops.text_attention import text_transformer_fused_forward

    model = TextTransformer(TextConfig(width=128, layers=3, heads=2, output_dim=64))
    model.reset_text_parameters(torch.Generator().manual_seed(0))
    model = cast_tower_(model, torch.bfloat16).to(cuda)
    rng = np.random.default_rng(7)
    ids = np.zeros((5, 77), np.int64)
    for row, n in enumerate((3, 10, 40, 76, 77)):
        ids[row, :n] = rng.integers(1, 49000, n)
        ids[row, n - 1] = 49407  # EOT, the largest id
    ids = torch.from_numpy(ids).to(cuda)
    with torch.no_grad():
        want = model.compute_text(ids)
        got = text_transformer_fused_forward(model, ids)
    cos = torch.nn.functional.cosine_similarity(got.float(), want.float(), dim=-1)
    assert cos.min().item() >= 0.999, cos


@pytest.mark.parametrize("label", list(BWD_SHAPES))
@pytest.mark.parametrize("name", ["time_subpath_backward", "space_subpath_backward"])
def test_backward_kernel_matches_plain(cuda, label, name):
    B, T, N, D, H = BWD_SHAPES[label]
    a = seeded_inputs(B, T, N, D, 7, cuda)
    g = seeded_inputs(B, T, N, D, 8, cuda)["x"]
    kernel, plain = backward_calls(bb, a, g, T, H)[name]
    before = getattr(bb, name).launches
    got = kernel()
    assert getattr(bb, name).launches == before + 1
    grad_band_check(name, GRAD_NAMES[name], got, plain())


@pytest.mark.parametrize("label", list(TEXT_BWD_SHAPES))
def test_text_backward_kernel_matches_plain(cuda, label):
    B, S, D, H, causal, eps, frozen = TEXT_BWD_SHAPES[label]
    a = text_inputs(B, S, D, 9, cuda)
    g = text_inputs(B, S, D, 10, cuda)["x"]
    kernel, plain = text_backward_calls(bb, ta, a, g, H, causal, eps, frozen)
    before = ta.text_subpath_backward.frozen_launches
    got = kernel()
    assert ta.text_subpath_backward.frozen_launches == before + frozen
    assert len(got) == (1 if frozen else 7)
    grad_band_check(label, GRAD_NAMES["text_subpath_backward"], got, plain())


def test_small_train_step_kernels_match_eager_on_card(cuda):
    """A 2-block model at head dim 64 (f32 masters, bf16 compute): the loss
    and gradients of train_apply against the eager forward, within the step-0
    gate of chip_smoke.py (|dloss| < 2e-2, relative error < 0.12 on the
    significant tensors)."""
    from tvts_torch.models.configs import SortConfig, TextConfig, TVTSv2Config, VisionConfig
    from tvts_torch.models.tvts_v2 import TVTSv2
    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.train.step import make_loss_fn

    cfg = TVTSv2Config(name="small", vision=VisionConfig(input_resolution=64, width=128,
                                                         layers=2, heads=2, output_dim=128,
                                                         num_frames=4, mask_ratio=0.5),
                       text=TextConfig(width=128, layers=3, heads=2, output_dim=128),
                       sort=SortConfig(embed_dim=128, num_heads=2))
    model = TVTSv2(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(18)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(0.02 * rng.standard_normal(p.shape).astype(np.float32)))
    model = model.to(cuda)
    model.set_compute_dtype(torch.bfloat16)
    B = 3
    ids = np.zeros((cfg.num_clips * B, 77), np.int64)
    ids[:, :20] = rng.integers(1, 49000, (cfg.num_clips * B, 20))
    ids[:, 20] = 49407
    batch = {"video": torch.tensor(rng.standard_normal((B, 4, 3, 64, 64)), dtype=torch.float32,
                                   device=cuda),
             "text_ids": torch.from_numpy(ids).to(cuda),
             "keep_ind": torch.stack([torch.randperm(16)[:8] for _ in range(B)]).to(cuda),
             "labels": torch.arange(cfg.num_clips).repeat(B, 1).to(cuda)}
    params = list(model.parameters())
    lk, _ = make_loss_fn(apply_fn=lambda m, b: train_apply(m, b, text_tune_from=1))(model, batch)
    gk = torch.autograd.grad(lk, params, allow_unused=True)
    le, _ = make_loss_fn()(model, batch)
    ge = torch.autograd.grad(le, params, allow_unused=True)
    assert abs(lk.item() - le.item()) < 2e-2
    gscale = max(g.abs().max().item() for g in ge)
    for p, a, b in zip(params, gk, ge):
        if b.abs().max().item() > 1e-2 * gscale and a is not None:
            assert (a - b).abs().max().item() / b.abs().max().item() < 0.12
