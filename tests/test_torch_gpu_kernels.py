"""The Hopper kernels (H1-H4 sub-paths of the video tower, H7 text attention,
the H5 / H6 / H7 training backwards, the H8 MLP sub-path with its backward and
the H9 attention cores, also in f32) against their plain PyTorch versions,
on the card in bf16, with chip_smoke.py's seeded inputs and bands; a small
train step, kernel path against eager; and prefetch_to_device's copies.
Marked `gpu`: they skip where no CUDA device is present.

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
    CORE_SHAPES,
    F32_BAND,
    GRAD_NAMES,
    MLP_GRAD_NAMES,
    MLP_SHAPES,
    TEXT_BWD_SHAPES,
    TEXT_CORE_SHAPES,
    TEXT_SHAPES,
    backward_calls,
    band_check,
    cls_row_check,
    core_band_check,
    core_calls,
    core_f32_check,
    core_inputs,
    f32_controls,
    grad_band_check,
    kernel_calls,
    ln_bwd_check,
    ln_bwd_inputs,
    mlp_calls,
    seeded_inputs,
    space_bwd_check,
    space_core_bwd_inputs,
    space_core_bwd_pair,
    text_backward_calls,
    text_calls,
    text_core_check,
    text_core_inputs,
    text_inputs,
)
from tvts_torch.ops import attention_cores as ac
from tvts_torch.ops import block_backward as bb
from tvts_torch.ops import block_kernels as bk
from tvts_torch.ops import text_attention as ta
from tvts_torch.ops.attention import divided_space_time_attention

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


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("label", list(MLP_SHAPES))
def test_mlp_subpath_kernel_matches_plain(cuda, label, save):
    """H8: the forward (and the hidden it saves) and every gradient, with the
    hidden recomputed and saved."""
    B, T, N, D, act = MLP_SHAPES[label]
    a = seeded_inputs(B, T, N, D, 7, cuda)
    g = seeded_inputs(B, T, N, D, 8, cuda)["x"]
    fwd, fwd_plain, bwd, bwd_plain = mlp_calls(bk, bb, a, g, act, save)
    (out, h), (want, want_h) = fwd(), fwd_plain()
    diff, ref, tol = band_check(out, want)
    assert diff <= tol, (diff, ref)
    assert (h is not None) == save
    if save:
        diff, ref, tol = band_check(h, want_h)
        assert diff <= tol, (diff, ref)
    before = bb.mlp_subpath.launches, bb.mlp_subpath_backward.saved_launches
    got = bwd()
    assert (bb.mlp_subpath.launches, bb.mlp_subpath_backward.saved_launches) == \
        (before[0] + 1, before[1] + save)
    grad_band_check(label, MLP_GRAD_NAMES, got, bwd_plain())


@pytest.mark.parametrize("mode", ["space", "time"])
@pytest.mark.parametrize("label", list(CORE_SHAPES))
def test_attention_core_kernel_matches_plain(cuda, label, mode):
    """H9 on the head-split views the tower hands it, and on contiguous
    [B, H, S, d] copies of them."""
    B, T, N, H, d = CORE_SHAPES[label]
    qkv = core_inputs(B, T, N, H, d, 3, cuda)
    kernel, plain = core_calls(ac, qkv, T, N, mode)
    before = ac.divided_space_time_attention_fused.launches
    got = kernel()
    assert ac.divided_space_time_attention_fused.launches == before + 1
    want = plain()
    diff, ref, tol = core_band_check(got, want)
    assert diff <= tol, (diff, ref)
    # no farther from plain in f32 than plain in bf16 is
    want32 = divided_space_time_attention(*(t.float() for t in qkv), T, N, mode)
    assert (got.float() - want32).abs().max() <= (want.float() - want32).abs().max()
    dense = core_calls(ac, tuple(t.contiguous() for t in qkv), T, N, mode)[0]()
    assert dense.is_contiguous() and torch.equal(dense, got)


@pytest.mark.parametrize("mode", ["space", "time"])
@pytest.mark.parametrize("label", list(CORE_SHAPES))
def test_attention_core_f32_kernel_matches_plain(cuda, label, mode):
    """H9 on f32 q, k, v: within F32_BAND * max|ref| of plain f32 (inside
    min(0.05, 0.02 * max|ref|)), which plain on what a TF32 mma or a
    bf16-staged kernel reads fails, and no farther from it than plain on the
    bf16-rounded inputs is; on the head-split views and on contiguous copies
    alike."""
    B, T, N, H, d = CORE_SHAPES[label]
    qkv = core_inputs(B, T, N, H, d, 3, cuda, dtype=torch.float32)
    before = ac.divided_space_time_attention_fused.f32_launches
    diff, ref, tol, tol16 = core_f32_check(ac, qkv, T, N, mode)
    assert ac.divided_space_time_attention_fused.f32_launches == before + 1
    assert tol == F32_BAND * ref
    assert diff <= min(tol, tol16), (diff, ref, tol, tol16)
    controls = f32_controls(qkv, T, N, mode)
    assert min(controls.values()) > tol, controls
    got = ac.divided_space_time_attention_fused(*qkv, T, N, mode)
    dense = ac.divided_space_time_attention_fused(*(t.contiguous() for t in qkv), T, N, mode)
    assert got.dtype == dense.dtype == torch.float32 and torch.equal(dense, got)


@pytest.mark.parametrize("d", [64, 80])
def test_attention_core_f32_raises_above_its_shared_memory(cuda, d):
    """The f32 space core stages a frame's keys and values in f32: a frame
    that does not fit a block raises ValueError, and is never sent to plain;
    the largest that fits runs."""
    n_max = ac.space_core_f32_max_patches(d)
    for N, ok in ((n_max, True), (n_max + 1, False)):
        q, k, v = core_inputs(1, 1, N, 1, d, 5, cuda, dtype=torch.float32)
        if ok:
            diff, ref, tol, _ = core_f32_check(ac, (q, k, v), 1, N, "space")
            assert diff <= tol, (diff, ref)
        else:
            with pytest.raises(ValueError, match=f"at most {n_max} patches"):
                ac.divided_space_time_attention_fused(q, k, v, 1, N, "space")


# (B, T, N, H, d): a ragged batch at the B/16 frame, the largest frame the f32
# space core takes at head dim 80
F32_CORE_CASES = {"B=3": (3, 12, 196, 12, 64),
                  "largest N d=80": (1, 2, ac.space_core_f32_max_patches(80), 2, 80)}


@pytest.mark.parametrize("mode", ["space", "time"])
@pytest.mark.parametrize("label", list(F32_CORE_CASES))
def test_attention_core_f32_ragged_batch_and_largest_frame(cuda, label, mode):
    """The f32 cores at a ragged batch and at the largest frame that fits,
    within F32_BAND * max|ref| of plain f32, on head-split views and on
    contiguous copies alike."""
    B, T, N, H, d = F32_CORE_CASES[label]
    qkv = core_inputs(B, T, N, H, d, 6, cuda, dtype=torch.float32)
    diff, ref, tol, _ = core_f32_check(ac, qkv, T, N, mode)
    assert diff <= tol, (diff, ref, tol)
    got = ac.divided_space_time_attention_fused(*qkv, T, N, mode)
    dense = ac.divided_space_time_attention_fused(*(t.contiguous() for t in qkv), T, N, mode)
    assert torch.equal(dense, got)


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("T", [1, 5, 12, 32])
def test_attention_core_f32_time_every_frame_count(cuda, T, d):
    """The f32 time core at 1 to 32 frames (its rows run four at a time, so
    5 leaves lanes idle) and three heads, within F32_BAND of plain f32, each
    call counted as an f32 time launch."""
    qkv = core_inputs(2, T, 49, 3, d, 7, cuda, dtype=torch.float32)
    before = ac.divided_space_time_attention_fused.f32_time_launches
    diff, ref, tol, _ = core_f32_check(ac, qkv, T, 49, "time")
    assert ac.divided_space_time_attention_fused.f32_time_launches == before + 1
    assert diff <= tol, (diff, ref, tol)


def test_attention_core_f32_refused_launch_raises(cuda, monkeypatch):
    """A launch the library refuses (a frame past the f32 space core's shared
    memory, its Python check taken away) raises; nothing falls back to plain,
    and nothing is counted."""
    N = ac.space_core_f32_max_patches(64) + 1
    qkv = core_inputs(1, 1, N, 1, 64, 8, cuda, dtype=torch.float32)
    monkeypatch.setattr(ac, "_check_space_frame_f32", lambda N, d: None)
    before = ac.divided_space_time_attention_fused.f32_launches
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA kernel launch failed"):
        ac.divided_space_time_attention_fused(*qkv, 1, N, "space")
    assert ac.divided_space_time_attention_fused.f32_launches == before


def test_attention_core_f32_frame_rule_is_the_librarys(cuda):
    """_check_space_frame_f32 (checked before the library loads) and the
    library's tvts_space_core_f32_fits (the rule the launch refuses by) agree
    on every frame size up to past the limit."""
    lib = bk.library()
    for d in (64, 80):
        for N in range(1, 1200):
            try:
                ac._check_space_frame_f32(N, d)
                fits = True
            except ValueError:
                fits = False
            assert fits == bool(lib.tvts_space_core_f32_fits(N, d)), (N, d)


def test_prefetch_to_device_is_bit_for_bit_the_host_batches(cuda):
    """50 host batches (f32, int32, int64, bool arrays and strings) through
    the pinned, side-stream copies while the consumer's stream is busy: a
    copy of every array taken on the consumer's stream as each batch arrives
    is bit for bit its host array."""
    from tvts_torch.data.prefetch import prefetch_to_device

    def batches():
        rng = np.random.default_rng(0)
        for i in range(50):
            yield {"video": rng.standard_normal((4, 12, 3, 64, 64)).astype(np.float32),
                   "keep_ind": rng.integers(0, 196, (4, 98)).astype(np.int32),
                   "text_ids": rng.integers(0, 49408, (16, 77)), "mask": rng.random(7) < 0.5,
                   "text": [f"caption {i}"], "step": i}

    want = list(batches())
    busy = torch.randn(2048, 2048, device=cuda)
    snaps = []
    for i, batch in enumerate(prefetch_to_device(batches(), size=3)):
        assert batch["step"] == i and batch["text"] == [f"caption {i}"]
        busy = busy @ busy.T / 2048  # keep the consumer's stream busy between batches
        snaps.append({k: batch[k].clone() for k in ("video", "keep_ind", "text_ids", "mask")})
    torch.cuda.synchronize()
    assert len(snaps) == 50
    for snap, host in zip(snaps, want):
        for key, t in snap.items():
            assert t.device.type == "cuda"
            assert torch.equal(t.cpu(), torch.from_numpy(host[key])), key


def test_attention_core_kernel_raises_on_what_it_does_not_take(cuda):
    q, k, v = core_inputs(1, 4, 16, 4, 64, 4, cuda)
    with pytest.raises(RuntimeError, match="forward only"):  # no graph: no silent zero gradient
        ac.divided_space_time_attention_fused(q.clone().requires_grad_(), k, v, 4, 16, "space")
    with pytest.raises(TypeError, match="all bf16 or all f32"):  # f32 is taken, mixed is not
        ac.divided_space_time_attention_fused(q.float(), k, v, 4, 16, "space")
    with pytest.raises(ValueError, match="head dim"):
        ac.divided_space_time_attention_fused(q[..., :32], k[..., :32], v[..., :32], 4, 16,
                                              "space")
    with pytest.raises(ValueError, match="share strides"):
        ac.divided_space_time_attention_fused(q, k, v.contiguous(), 4, 16, "space")


def _small_train(cuda):
    """A 2-block model at head dim 64 (f32 masters, bf16 compute, seeded
    noise on every leaf) and a seeded batch of 3 clips, on the card."""
    from tvts_torch.models.configs import SortConfig, TextConfig, TVTSv2Config, VisionConfig
    from tvts_torch.models.tvts_v2 import TVTSv2

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
             "keep_ind": torch.from_numpy(np.stack([rng.permutation(16)[:8]
                                                    for _ in range(B)])).to(cuda),
             "labels": torch.arange(cfg.num_clips).repeat(B, 1).to(cuda)}
    return model, batch


def test_small_train_step_kernels_match_eager_on_card(cuda):
    """A 2-block model at head dim 64 (f32 masters, bf16 compute): the loss
    and gradients of train_apply (H5, H6, H7 and H8) against the eager forward, within the step-0
    gate of chip_smoke.py (|dloss| < 2e-2, relative error < 0.12 on the
    significant tensors)."""
    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.train.step import make_loss_fn

    model, batch = _small_train(cuda)
    params = list(model.parameters())
    lk, _ = make_loss_fn(apply_fn=lambda m, b: train_apply(m, b, text_tune_from=1,
                                                           mlp_kernel=True))(model, batch)
    gk = torch.autograd.grad(lk, params, allow_unused=True)
    le, _ = make_loss_fn()(model, batch)
    ge = torch.autograd.grad(le, params, allow_unused=True)
    assert abs(lk.item() - le.item()) < 2e-2
    gscale = max(g.abs().max().item() for g in ge)
    for p, a, b in zip(params, gk, ge):
        if b.abs().max().item() > 1e-2 * gscale and a is not None:
            assert (a - b).abs().max().item() / b.abs().max().item() < 0.12


def test_tp_kernel_path_launches_and_numbers_on_card(cuda):
    """The kernel path (H5, H6, H7 and H8) of a tp copy on a 1-rank NCCL
    group, the tp code path forced (parallel/tensor_parallel.tp_shard at
    group size 1; the kernels take each block's slices gathered whole):
    every kernel launched as often as on the unsharded model, and the loss
    and every gradient bit for bit the unsharded model's."""
    from functools import partial

    from chip_smoke import grads_of, launch_counts, one_rank_mesh, reset_launch_counts, tp_copy
    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.train.step import make_loss_fn

    model, batch = _small_train(cuda)
    loss_fn = make_loss_fn(apply_fn=partial(train_apply, text_tune_from=1, mlp_kernel=True))
    reset_launch_counts(bk, bb, ta)
    loss, grads = grads_of(model, loss_fn, batch)
    torch.cuda.synchronize()
    want = launch_counts(bk, bb, ta)
    assert want["space_subpath"] == want["time_subpath"] == want["mlp_subpath"] == 2
    with one_rank_mesh(cuda) as mesh:
        copy = tp_copy(model, mesh)
        reset_launch_counts(bk, bb, ta)
        loss_t, grads_t = grads_of(copy, loss_fn, batch)
        torch.cuda.synchronize()
        assert launch_counts(bk, bb, ta) == want
    assert loss_t == loss
    for name, g in grads.items():
        assert torch.equal(grads_t[name], g), name


# ---------------------------------------------------------------------------
# ln_gemm on its own, against the plain product
# ---------------------------------------------------------------------------
def _gemm_operands(M, N, K, lda, seed, dev, ln_eps=None, hidden_dtype=None):
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    ops = dict(x=torch.randn(M, lda, generator=gen, device=dev, dtype=bf) + 0.5,
               w=torch.randn(N, K, generator=gen, device=dev, dtype=bf) * K ** -0.5,
               b=0.1 * torch.randn(N, generator=gen, device=dev, dtype=bf),
               res=torch.randn(M, N, generator=gen, device=dev, dtype=bf))
    if ln_eps is not None:
        ops["ln"] = (1 + 0.1 * torch.randn(K, generator=gen, device=dev),
                     0.1 * torch.randn(K, generator=gen, device=dev))
    if hidden_dtype is not None:
        ops["hidden"] = torch.randn(M, N, generator=gen, device=dev, dtype=hidden_dtype)
    return ops


def _gemm_plain(o, K, act, epi, ln_eps):
    """The product in f32 from the same bf16 operands, rounded where the
    kernel rounds: LN(x) and, when saved, the pre-activation h."""
    from tvts_torch.models.layers import get_activation, layer_norm_f32

    a = o["x"][:, :K]
    if ln_eps is not None:
        a = layer_norm_f32(a, *o["ln"], ln_eps)
    y = a.float() @ o["w"].float().T
    if epi.startswith("act_grad"):
        h = o["hidden"].float().requires_grad_()
        ah = get_activation(act)(h)
        (dh,) = torch.autograd.grad(ah, h, y)
        return dh.detach(), ah.detach()
    y = y + o["b"].float()
    pre = None
    if epi == "save":
        pre = y.to(torch.bfloat16)
        y = pre.float()
    y = get_activation(act)(y) if act != "none" else y
    if epi == "residual":
        y = y + o["res"].float()
    return y, pre


def _gemm_check(got, want):
    scale = want.float().abs().max().item()
    diff = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got.float()).all() and diff <= 1e-2 * scale + 1e-2, (diff, scale)


GEMM_CASES = [  # (epilogue, LayerNorm eps or None, activation)
    ("plain", None, "none"), ("plain", 1e-5, "quick_gelu"), ("plain", 1e-6, "gelu"),
    ("residual", None, "none"), ("residual", 1e-5, "gelu"),
    ("f32", None, "none"), ("f32", 1e-5, "none"), ("f32", 1e-6, "none"),
    ("save", 1e-5, "quick_gelu"), ("save", 1e-6, "gelu"),
    ("act_grad_bf16", None, "quick_gelu"), ("act_grad_bf16", None, "gelu"),
    ("act_grad_f32", None, "quick_gelu"), ("act_grad_f32", None, "gelu"),
]


def _run_gemm(o, M, N, K, lda, epi, ln_eps, act):
    bf = torch.bfloat16
    dev = o["x"].device
    out = torch.empty(M, N, device=dev, dtype=torch.float32 if epi == "f32" else bf)
    kw = dict(act=act, eps=ln_eps or bk.LN_EPS)
    bias = o["b"]
    if epi == "residual":
        kw.update(res=o["res"], ldres=N)
    if epi == "save":
        kw["pre"] = torch.empty_like(out)
    if epi.startswith("act_grad"):
        kw.update(hidden=o["hidden"], act_out=torch.empty_like(out))
        bias = None
    bk._ln_gemm(bk.library(), o["x"], M, lda, o.get("ln"), o["w"], bias, out, **kw)
    torch.cuda.synchronize()
    return out, kw.get("pre", kw.get("act_out"))


@pytest.mark.parametrize("case", GEMM_CASES, ids=lambda c: f"{c[0]}-{c[1]}-{c[2]}")
def test_ln_gemm_matches_plain_at_every_epilogue(cuda, case):
    epi, ln_eps, act = case
    M, N, K = 300, 768, 768
    hdt = {"act_grad_bf16": torch.bfloat16, "act_grad_f32": torch.float32}.get(epi)
    o = _gemm_operands(M, N, K, K, 40, cuda, ln_eps, hdt)
    got, second = _run_gemm(o, M, N, K, K, epi, ln_eps, act)
    want, want2 = _gemm_plain(o, K, act, epi, ln_eps)
    _gemm_check(got, want)
    if want2 is not None:
        _gemm_check(second, want2)


@pytest.mark.parametrize("M", [1, 63, 65, 150592])
@pytest.mark.parametrize("strided", [False, True])
def test_ln_gemm_ragged_rows_and_strided_a(cuda, M, strided):
    N, K = 256 + 64, 768  # N ragged too
    lda = 3 * K if strided else K  # e.g. the q third of a [M, 3K] row
    for ln_eps in (None, 1e-5):
        o = _gemm_operands(M, N, K, lda, 41, cuda, ln_eps)
        got, _ = _run_gemm(o, M, N, K, lda, "plain", ln_eps, "none")
        _gemm_check(got, _gemm_plain(o, K, "none", "plain", ln_eps)[0])


@pytest.mark.parametrize("K", [512, 768, 1280, 3072, 5120])
def test_ln_gemm_every_depth(cuda, K):
    M, N = 257, 512
    for ln_eps, epi in ((None, "residual"), (1e-5, "plain"), (None, "f32")):
        o = _gemm_operands(M, N, K, K, 42, cuda, ln_eps)
        got, _ = _run_gemm(o, M, N, K, K, epi, ln_eps, "none")
        _gemm_check(got, _gemm_plain(o, K, "none", epi, ln_eps)[0])


def test_ln_gemm_raises_before_launch_on_what_it_does_not_take(cuda):
    o = _gemm_operands(64, 256, 96, 96, 43, cuda)
    with pytest.raises(ValueError, match="K = 96"):
        _run_gemm(o, 64, 256, 96, 96, "plain", None, "none")
    o = _gemm_operands(64, 256, 768, 776, 44, cuda)
    o["x"] = o["x"].view(-1)[1:].clone()[:63 * 776 + 1][1:].view(63, 776)  # 2 bytes off
    assert o["x"].data_ptr() % 16
    with pytest.raises(ValueError, match="x at .* not 16-byte aligned"):
        _run_gemm(o, 63, 256, 768, 776, "plain", None, "none")


# ---------------------------------------------------------------------------
# the time core on its own (packed with lse; strided), against plain
# ---------------------------------------------------------------------------
def _time_plain(qkv, T, N, H, d):
    """Patch rows of the time attention and their lse, in f32 from the bf16
    qkv [B, S, 3D] (q scaled by d^-0.5)."""
    B, S, _ = qkv.shape
    q, k, v = (t.float().view(B, S, H, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    q = q[:, :, 1:].reshape(B, H, T, N, d).permute(0, 1, 3, 2, 4) * d ** -0.5  # [B,H,N,T,d]
    kp = k[:, :, 1:].reshape(B, H, T, N, d).permute(0, 1, 3, 2, 4)
    vp = v[:, :, 1:].reshape(B, H, T, N, d).permute(0, 1, 3, 2, 4)
    keys = torch.cat([k[:, :, :1, None].expand(B, H, N, 1, d), kp], dim=3)
    vals = torch.cat([v[:, :, :1, None].expand(B, H, N, 1, d), vp], dim=3)
    logits = q @ keys.transpose(-1, -2)  # [B, H, N, T, 1 + T]
    out = torch.softmax(logits, -1) @ vals  # [B, H, N, T, d]
    lse = torch.logsumexp(logits, -1)  # [B, H, N, T]
    out = out.permute(0, 3, 2, 1, 4).reshape(B, T * N, H * d)
    return out, lse.permute(0, 1, 3, 2).reshape(B, H, T * N)


@pytest.mark.parametrize("N", [49, 196, 256])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("T", [1, 12, 16, 32])
def test_time_core_matches_plain(cuda, T, d, N):
    H = 12 if d == 64 else 16
    B, S, D = 2 if N < 256 else 1, 1 + T * N, H * d
    rng = np.random.default_rng(45)
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * D)), dtype=torch.bfloat16, device=cuda)
    lib = bk.library()
    out = torch.zeros(B, S, D, dtype=torch.bfloat16, device=cuda)
    lse = torch.zeros(B, H, S, dtype=torch.float32, device=cuda)
    bk._check(lib, lib.tvts_time_core(bk._ptr(qkv), bk._ptr(out), bk._ptr(lse), B, T, N, H, d,
                                      d ** -0.5, bk._stream(qkv)))
    torch.cuda.synchronize()
    want, want_lse = _time_plain(qkv, T, N, H, d)
    diff = (out[:, 1:].float() - want).abs().max().item()
    assert diff <= 0.01 * want.abs().max().item(), diff  # the bf16 store only
    assert (lse[:, :, 1:] - want_lse).abs().max().item() <= 1e-3
    assert not out[:, 0].any()  # the CLS row is the split-KV kernel's
    # strided (H9): the head-split views of the same rows, q pre-scaled
    from tvts_torch.ops.attention import split_heads

    q, k, v = qkv.chunk(3, dim=-1)
    q, k, v = split_heads(q * d ** -0.5, H), split_heads(k, H), split_heads(v, H)
    got = ac.divided_space_time_attention_fused(q, k, v, T, N, "time")
    plain = divided_space_time_attention(q, k, v, T, N, "time")
    diff, ref, tol = core_band_check(got, plain)
    assert diff <= tol, (diff, ref)


# ---------------------------------------------------------------------------
# the space core on its own (packed with its CLS fold and lse; strided),
# and H4 at the model shapes, against plain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [49, 196, 256])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("T", [1, 12, 32])
def test_space_core_matches_plain(cuda, T, d, N):
    """The packed core with its CLS fold (H2, H5's saving forward): every
    row and every row's lse, the CLS row (f32 P V) within half a bf16 unit
    of plain; then the strided core (H9) on the head-split views of the same
    rows."""
    H = 12 if d == 64 else 16
    B, S, D = 2 if N < 256 else 1, 1 + T * N, H * d
    rng = np.random.default_rng(46)
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * D)), dtype=torch.bfloat16, device=cuda)
    out, lse = bk.space_core(qkv, T, H, with_lse=True)
    torch.cuda.synchronize()
    want, want_lse = bk.space_core_plain(qkv, T, H)
    scale = want.abs().max().item()
    diff = (out.float() - want).abs().max().item()
    assert diff <= 0.01 * scale, diff  # the bf16 store (and the patch rows' P in bf16) only
    cls_row_check(out[:, 0], want[:, 0])
    assert (lse - want_lse).abs().max().item() <= 1e-3
    from tvts_torch.ops.attention import split_heads

    q, k, v = qkv.chunk(3, dim=-1)
    q, k, v = split_heads(q * d ** -0.5, H), split_heads(k, H), split_heads(v, H)
    got = ac.divided_space_time_attention_fused(q, k, v, T, N, "space")
    plain = divided_space_time_attention(q, k, v, T, N, "space")
    diff, ref, tol = core_band_check(got, plain)
    assert diff <= tol, (diff, ref)


def test_space_core_is_deterministic(cuda):
    """The CLS partials merge in a fixed order: two runs agree bit for bit."""
    rng = np.random.default_rng(47)
    qkv = torch.tensor(rng.standard_normal((2, 1 + 12 * 196, 3 * 768)), dtype=torch.bfloat16,
                       device=cuda)
    first, first_lse = bk.space_core(qkv, 12, 12, with_lse=True)
    out, lse = bk.space_core(qkv, 12, 12, with_lse=True)
    assert torch.equal(out, first) and torch.equal(lse, first_lse)


@pytest.mark.parametrize("d, n_max", [(64, 783), (80, 639)])
def test_space_core_raises_above_its_shared_memory(cuda, d, n_max):
    """A frame's 1 + N keys and values must fit one block's shared memory:
    the largest N runs, one more raises before any launch, in the core, in
    H2 and in H9."""
    H, T = 2, 1
    qkv = torch.randn(1, 1 + T * n_max, 3 * H * d, device=cuda, dtype=torch.bfloat16)
    out = bk.space_core(qkv, T, H)
    torch.cuda.synchronize()
    cls_row_check(out[:, 0], bk.space_core_plain(qkv, T, H)[0][:, 0])
    qkv = torch.randn(1, 2 + T * n_max, 3 * H * d, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"at most {n_max} patches"):
        bk.space_core(qkv, T, H)
    a = seeded_inputs(1, T, n_max + 1, H * d, 49, cuda)
    with pytest.raises(ValueError, match=f"at most {n_max} patches"):
        bk.fused_space_block(a["x"], a["base"], a["ln_w"], a["ln_b"], a["wqkv"], a["bqkv"],
                             a["wproj"], a["bproj"], T, H)
    q, k, v = (t.reshape(1, 2 + T * n_max, H, d).transpose(1, 2) for t in qkv.chunk(3, -1))
    with pytest.raises(ValueError, match=f"at most {n_max} patches"):
        ac.divided_space_time_attention_fused(q, k, v, T, n_max + 1, "space")


# (B, T, N, D, H): B/16, B/32 and H/14 widths, an odd batch
CLS_ONLY_SHAPES = [(3, 12, 196, 768, 12), (5, 12, 49, 768, 12), (3, 4, 256, 1280, 16)]


@pytest.mark.parametrize("shape", CLS_ONLY_SHAPES, ids=lambda s: f"N{s[2]}-D{s[3]}")
def test_cls_only_kernel_matches_plain_at_model_shapes(cuda, shape):
    B, T, N, D, H = shape
    kernel, plain = kernel_calls(bk, seeded_inputs(B, T, N, D, 48, cuda), T, H,
                                 "gelu")["fused_space_cls_only"]
    before = bk.fused_space_cls_only.launches
    got = kernel()
    assert bk.fused_space_cls_only.launches == before + 1
    torch.cuda.synchronize()
    want = plain()
    assert got.shape == want.shape == (B, 1, D)
    diff, ref, tol = band_check(got, want)
    assert diff <= tol, (diff, ref)
    again = kernel()  # chunks merged in a fixed order: no run-to-run drift
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# wgrad (TMA + wgmma, split-M) on its own, against an f32 product
# ---------------------------------------------------------------------------
def _wgrad_operands(M, N1, N2, seed, dev, ln):
    """a [M, N1], b [M, N2] bf16; with `ln`, b's row statistics and LayerNorm
    parameters whose weights are powers of two (so the kernel's fused
    multiply-add and plain torch round LN(b) alike, to the same bf16 values)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    a = torch.randn(M, N1, generator=gen, device=dev, dtype=bf)
    b = torch.randn(M, N2, generator=gen, device=dev, dtype=bf) + 0.5
    if not ln:
        return a, b, None, None
    w = 2.0 ** torch.randint(-1, 2, (N2,), generator=gen, device=dev).float()
    bias = torch.randint(-8, 9, (N2,), generator=gen, device=dev).float() / 8
    bf32 = b.float()
    stats = torch.stack([bf32.mean(-1), torch.rsqrt(bf32.var(-1, unbiased=False) + 1e-5)], -1)
    return a, b, stats, (w, bias)


def bf16_unit(x: torch.Tensor) -> torch.Tensor:
    """One bf16 unit in the last place at |x|: 2^(floor(log2 |x|) - 7)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def _wgrad_check(got, want):
    """Every element within one bf16 unit of the f32 reference, plus 1e-5 *
    max|ref| where the sum nearly cancels and the f32 summation order decides
    the last bits."""
    want = want.float()
    diff = (got.float() - want).abs()
    bound = bf16_unit(want) + 1e-5 * want.abs().max()
    assert torch.isfinite(got.float()).all()
    assert (diff <= bound).all(), (diff.max().item(), (diff > bound).sum().item())


# (M, N1, N2, LayerNorm on b): attention D = 512, 768, 1280 (dWproj, dWqkv),
# the MLP's two products, a ragged M, an M below one split, ragged N1 and N2
WGRAD_CASES = [(6160, 512, 512, False), (6160, 1536, 512, True),
               (23540, 768, 768, False), (23540, 2304, 768, True),
               (7304, 1280, 1280, False), (7304, 3840, 1280, True),
               (23540, 768, 3072, False), (23540, 3072, 768, True),
               (1001, 768, 768, True), (40, 2304, 768, True), (300, 200, 328, True)]


@pytest.mark.parametrize("case", WGRAD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_wgrad_matches_f32_reference(cuda, case):
    M, N1, N2, ln = case
    a, b, stats, lnp = _wgrad_operands(M, N1, N2, 50, cuda, ln)
    before = bb.wgrad.launches
    dw, db = bb.wgrad(a, b, stats, lnp)
    torch.cuda.synchronize()
    assert bb.wgrad.launches == before + 1
    assert dw.shape == (N1, N2) and db.shape == (N1,) and dw.dtype == torch.bfloat16
    bl = b if lnp is None else ((b.float() - stats[:, :1]) * stats[:, 1:] * lnp[0]
                                + lnp[1]).to(torch.bfloat16)
    _wgrad_check(dw, a.float().t() @ bl.float())
    _wgrad_check(db, a.float().sum(0))
    dw32, db32 = bb.wgrad(a, b, stats, lnp, dtype=torch.float32)
    _wgrad_check(dw32, a.float().t() @ bl.float())
    again = bb.wgrad(a, b, stats, lnp, dtype=torch.float32)  # fixed-order partial sums
    assert torch.equal(again[0], dw32) and torch.equal(again[1], db32)


def test_wgrad_raises_before_launch_on_what_it_does_not_take(cuda):
    a, b, _, _ = _wgrad_operands(64, 768, 768, 51, cuda, False)
    with pytest.raises(ValueError, match="N1 = 12"):
        bb.wgrad(a[:, :12].contiguous(), b)
    lib = bk.library()
    with pytest.raises(ValueError, match="lda = 772"):
        bb._wgrad(lib, torch.empty(64, 772, device=cuda, dtype=torch.bfloat16)[:, :768], b)
    off = torch.empty(64 * 768 + 8, device=cuda, dtype=torch.bfloat16)[1:1 + 64 * 768]
    with pytest.raises(ValueError, match="a at .* not 16-byte aligned"):
        bb._wgrad(lib, off.view(64, 768), b)


# ---------------------------------------------------------------------------
# the backward time core on its own, against autograd of the plain core
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [49, 76, 98, 196])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("T", [1, 12, 32])
def test_time_core_backward_matches_autograd_of_plain(cuda, T, d, N):
    """dq, dk, dv of every row (the CLS row from the groups' partials after
    the combine) within the bf16 store of autograd's f32 value, plus 1e-4 *
    max|ref| where a sum nearly cancels; two runs bit-equal."""
    H = 12 if d == 64 else 16
    B, S, D = 2 if T * N < 3000 else 1, 1 + T * N, H * d
    rng = np.random.default_rng(52)
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * D)), dtype=torch.bfloat16, device=cuda)
    dO = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.bfloat16, device=cuda)
    q32 = qkv.float().requires_grad_()
    out, lse = bb.time_core_plain(q32, T, H)
    (want,) = torch.autograd.grad(out, q32, dO.float())
    out = out.detach()
    delta = (dO.float() * out).reshape(B, S, H, d).sum(-1).transpose(1, 2).contiguous()
    lse = lse.detach().contiguous()
    before = bb.time_core_backward.launches
    got = bb.time_core_backward(qkv, dO, lse, delta, T, H)
    torch.cuda.synchronize()
    assert bb.time_core_backward.launches == before + 1
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16
    diff = (got.float() - want).abs()
    bound = 2.0 ** -8 * want.abs() + 1e-4 * want.abs().max()
    assert (diff <= bound).all(), (diff.max().item(), (diff > bound).sum().item())
    assert torch.equal(bb.time_core_backward(qkv, dO, lse, delta, T, H), got)


def test_time_core_backward_raises_before_launch(cuda):
    T, N, H, d = 33, 4, 2, 64
    qkv = torch.zeros(1, 1 + T * N, 3 * H * d, device=cuda, dtype=torch.bfloat16)
    dO = torch.zeros(1, 1 + T * N, H * d, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, H, 1 + T * N, device=cuda)
    with pytest.raises(ValueError, match="33 frames"):
        bb.time_core_backward(qkv, dO, lse, lse, T, H)
    with pytest.raises(TypeError):
        bb.time_core_backward(qkv[:, :1 + 12 * N].contiguous(), dO[:, :1 + 12 * N].float(),
                              lse[:, :, :1 + 12 * N].contiguous(),
                              lse[:, :, :1 + 12 * N].contiguous(), 12, H)


# ---------------------------------------------------------------------------
# the LayerNorm backward (row pass and column sums) against plain in f64
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("M", [1, 37, 1001, 23540])
@pytest.mark.parametrize("K", [512, 768, 1280])
def test_ln_backward_matches_plain(cuda, K, M):
    """dx within one bf16 unit of plain (f64) plus 1e-5 * max|ref|, dln_w and
    dln_b within 1e-4 * max|ref| of f64 sums (ln_bwd_check), with and without
    the residual and frozen (dx only); two runs bit-equal."""
    x, stats, dxln, ln_w, res = ln_bwd_inputs(M, K, 59, cuda)
    for r, wg in ((res, True), (None, True), (res, False), (None, False)):
        before = bb.ln_backward.launches
        got = bb.ln_backward(x, stats, dxln, ln_w, r, weight_grads=wg)
        torch.cuda.synchronize()
        assert bb.ln_backward.launches == before + 1
        assert got[0].shape == (M, K) and got[0].dtype == torch.bfloat16
        assert (got[1] is None) == (not wg) and (got[2] is None) == (not wg)
        ln_bwd_check(bb, got, (x, stats, dxln, ln_w, r))
        again = bb.ln_backward(x, stats, dxln, ln_w, r, weight_grads=wg)
        for a, b in zip(got, again):
            assert (a is None and b is None) or torch.equal(a, b)


def test_ln_backward_raises_before_launch(cuda):
    x, stats, dxln, ln_w, _ = ln_bwd_inputs(4, 1288, 60, cuda)
    before = bb.ln_backward.launches
    with pytest.raises(ValueError, match="K = 1288"):
        bb.ln_backward(x, stats, dxln, ln_w)
    with pytest.raises(TypeError):
        bb.ln_backward(x[:, :768].contiguous().float(), stats, dxln[:, :768].contiguous(),
                       ln_w[:768].contiguous())
    lib = bk.library()
    off = torch.empty(4 * 768 + 4, device=cuda)[1:1 + 4 * 768].view(4, 768)
    with pytest.raises(ValueError, match="dxln at .* not 16-byte aligned"):
        bb._ln_backward(lib, x[:, :768].contiguous(), stats, off, ln_w[:768].contiguous(), None,
                        True)
    assert bb.ln_backward.launches == before


# ---------------------------------------------------------------------------
# the backward space core: one pass, against autograd of plain and the pair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("N", [1, 49, 76, 98, 196])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("T", [1, 8, 12])
def test_space_core_backward_matches_plain_and_the_pair(cuda, T, d, N):
    """dq, dk, dv of every row (the CLS row from the frames' partials after
    the combine) against autograd's f32 value within space_bwd_check's band
    (P and dS rounded to bf16 for the products, as in the flash pair); dqkv
    and the CLS partials bit for bit the flash pair's; two runs bit-equal."""
    H = 12 if d == 64 else 16
    B, S, D = 2, 1 + T * N, H * d
    rng = np.random.default_rng(53)
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * D)), dtype=torch.bfloat16, device=cuda)
    dO = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.bfloat16, device=cuda)
    q32 = qkv.float().requires_grad_()
    out, lse = bk.space_core_plain(q32, T, H)
    (want,) = torch.autograd.grad(out, q32, dO.float())
    out = out.detach()
    delta = (dO.float() * out).reshape(B, S, H, d).sum(-1).transpose(1, 2).contiguous()
    lse = lse.detach().contiguous()
    before = bb.space_core_backward.launches, bb.space_core_backward.pair_launches
    got = bb.space_core_backward(qkv, dO, lse, delta, T, H)
    torch.cuda.synchronize()
    assert (bb.space_core_backward.launches, bb.space_core_backward.pair_launches) == (
        before[0] + 1, before[1])
    assert got.shape == qkv.shape and got.dtype == torch.bfloat16
    space_bwd_check(got, want, T, H)
    with torch.cuda.device(cuda):
        dqkv, partial = bb._space_core_backward(bk.library(), qkv, dO, lse, delta, T, H)
    pair = space_core_bwd_pair(bb, qkv, dO, lse, delta, T, H)
    assert torch.equal(dqkv, pair[0]) and torch.equal(partial, pair[1])
    assert torch.equal(dqkv, got)  # and run to run


def test_space_core_backward_takes_the_pair_above_one_block(cuda):
    """A group over one block's shared memory (N = 400 at d = 64: 416 rows)
    takes the flash pair, counted apart, and still matches plain."""
    T, N, H, d = 1, 400, 2, 64
    assert not bb._check_space_bwd(T, N, H, d)
    qkv, dO, lse, delta = space_core_bwd_inputs(1, T, N, H, d, 61, cuda, bb)
    before = bb.space_core_backward.launches, bb.space_core_backward.pair_launches
    got = bb.space_core_backward(qkv, dO, lse, delta, T, H)
    torch.cuda.synchronize()
    assert (bb.space_core_backward.launches, bb.space_core_backward.pair_launches) == (
        before[0], before[1] + 1)
    space_bwd_check(got, bb.space_core_backward_plain(qkv, dO, lse, delta, T, H), T, H)


def test_space_core_backward_dispatch_rule_is_the_librarys(cuda):
    """_check_space_bwd (the rule planned on any device) and the library's
    tvts_space_bwd_one_block (the rule the card dispatches on and the launch
    refuses by) agree on every group size up to past the limit."""
    lib = bk.library()
    for d in (64, 80):
        for N in range(1, 1200):
            assert bb._check_space_bwd(1, N, 1, d) == bool(lib.tvts_space_bwd_one_block(N, d)), (
                N, d)


def test_space_core_backward_raises_before_launch(cuda):
    T, N, H = 2, 5, 4
    qkv = torch.zeros(1, 1 + T * N, 3 * H * 32, device=cuda, dtype=torch.bfloat16)
    dO = torch.zeros(1, 1 + T * N, H * 32, device=cuda, dtype=torch.bfloat16)
    lse = torch.zeros(1, H, 1 + T * N, device=cuda)
    before = bb.space_core_backward.launches, bb.space_core_backward.pair_launches
    with pytest.raises(ValueError, match="head dim 32"):
        bb.space_core_backward(qkv, dO, lse, lse, T, H)
    with pytest.raises(TypeError):
        bb.space_core_backward(qkv, dO.float(), lse, lse, T, H)
    assert (bb.space_core_backward.launches, bb.space_core_backward.pair_launches) == before


# the H7 cores alone: the train steps' shapes, then ragged and short sequences
# of both kernels (the one-block kernel up to S = 128, the TMA + wgmma ones above)
TEXT_CORE_CASES = {**TEXT_CORE_SHAPES, "S=131 causal": (3, 131, 4, True),
                   "S=131": (3, 131, 4, False), "S=300 causal": (2, 300, 2, True),
                   "S=129": (1, 129, 2, False), "S=5 causal": (2, 5, 2, True),
                   "S=128": (2, 128, 2, False)}


@pytest.mark.parametrize("label", list(TEXT_CORE_CASES))
def test_text_core_matches_plain_and_is_deterministic(cuda, label):
    """out, lse and dq, dk, dv of the H7 cores against their plain versions
    (chip_smoke.text_core_check: out in the H7 band, lse within 1e-3, each
    gradient within 0.06 * max|ref|), two runs bit-equal, each launch
    counted."""
    B, S, H, causal = TEXT_CORE_CASES[label]
    qkv, dO = text_core_inputs(B, S, H, 62, cuda)
    before = ta.text_core.launches, ta.text_core_backward.launches
    text_core_check(label, ta, qkv, dO, H, causal)
    assert (ta.text_core.launches, ta.text_core_backward.launches) == (before[0] + 2,
                                                                       before[1] + 2)


@pytest.mark.parametrize("S", [77, 300])
def test_text_core_is_causal_and_raises_before_launch(cuda, S):
    """Rows after 39 reach no earlier row's out, lse or dq; what the cores do
    not take raises before any launch."""
    qkv, dO = text_core_inputs(2, S, 4, 63, cuda)
    out, lse = ta.text_core(qkv, 4, True, with_lse=True)
    dq = ta.text_core_backward(qkv, out, lse, dO, 4, True)[..., :256]
    cut = qkv.clone()
    cut[:, 40:] = 0
    out2, lse2 = ta.text_core(cut, 4, True, with_lse=True)
    dq2 = ta.text_core_backward(cut, out2, lse2, dO, 4, True)[..., :256]
    assert torch.equal(out[:, :40], out2[:, :40]) and torch.equal(lse[..., :40], lse2[..., :40])
    assert torch.equal(dq[:, :40], dq2[:, :40])
    before = ta.text_core.launches, ta.text_core_backward.launches
    with pytest.raises(ValueError, match="head dim 32"):
        ta.text_core(qkv, 8, True)
    with pytest.raises(TypeError):
        ta.text_core(qkv.float(), 4, True)
    with pytest.raises(ValueError, match="contiguous"):
        ta.text_core(qkv[:, :, 8:-8], 4, True)
    with pytest.raises(ValueError, match="head dim 32"):
        ta.text_core_backward(qkv, out, torch.zeros(2, 8, S, device=cuda), dO, 8, True)
    assert (ta.text_core.launches, ta.text_core_backward.launches) == before


# the sha256 of the flash pair's dqkv (SPACE = true) on the inputs of
# chip_smoke.space_core_bwd_digests (seed 55) at the B/16 and H/14 train
# shapes, as the tree before the H7 cores' redesign printed them on an H100:
# the pair is the one-pass space core's oracle, and the redesign left it as it
# was
SPACE_PAIR_DQKV_SHA256 = {
    (2, 12, 98, 12, 64): "2f030726f0dd4f28ff518eaa40029db50667a41b7c358aff3a3dd97c36eef441",
    (1, 12, 76, 16, 80): "b9a88f467d7ed14ccc4b099343824972aa5688bbcae75c737f1ef533ba21be51"}


@pytest.mark.parametrize("shape", list(SPACE_PAIR_DQKV_SHA256), ids=["B/16", "H/14"])
def test_space_flash_pair_digests_unchanged(cuda, shape):
    import hashlib

    B, T, N, H, d = shape
    inputs = space_core_bwd_inputs(B, T, N, H, d, 55, cuda, bb)  # space_core_bwd_digests' seed
    dqkv, _ = space_core_bwd_pair(bb, *inputs, T, H)
    torch.cuda.synchronize()
    digest = hashlib.sha256(dqkv.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
    assert digest == SPACE_PAIR_DQKV_SHA256[shape]
