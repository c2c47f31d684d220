"""VideoMAE V2's ViT-g/14 on the port (downstream/model.vit_giant_patch14_224,
the joint blocks through ops/fused_forward, the H7 core at head dim 88):

- on the CPU, at a tiny size with the ViT-g block's shape (2 heads of 88, 2
  tubes of 4 patches, 2 blocks, mlp_ratio 48/11, LayerNorm eps 1e-6): the
  port's FinetuneViT, eager and through make_cls_eval_step(use_fused=True),
  against the plain reference benchmark/reference/videomae.py on the same
  seeded weights, f32 logits within F32_TOL (sums in another order; a wrong
  eps, bias fold or scale moves them by 1e-3 or more); JointViT's fused
  forward against the JAX package's JointViT (imported inside that test);
  the q/v-bias fold; text_core_plan at d = 88; the published sizes and
  parameter count; the CLI's sizes by name; H3's eps; the spans of the
  classification entry;
- marked `gpu` (no JAX here: run with `python -m pytest -m gpu --noconftest
  tests/test_torch_videomae_g.py`): the d = 88 core against text_core_plain
  at the cell's shape and at S = 2,047, causal at S = 300; the d = 64 core's
  outputs bit for bit those of the tree before d = 88 (sha256); H3's eps on
  the card; the tiny model on the kernels against the reference; the d = 88
  backward refused before any launch.
"""

import hashlib

import numpy as np
import pytest
import torch

from benchmark.reference import model as ref
from benchmark.reference import videomae
from tvts_torch.downstream import engine
from tvts_torch.downstream import model as ft
from tvts_torch.models.joint_vit import JointViT
from tvts_torch.ops import block_kernels as bk
from tvts_torch.ops import fused_forward
from tvts_torch.ops import text_attention as ta
from tvts_torch.utils import profiling
from tvts_torch.utils.convert import convert_v1_state_dict

TINY = {"img_size": 28, "patch_size": 14, "num_frames": 4, "tubelet_size": 2, "embed_dim": 176,
        "depth": 2, "num_heads": 2, "mlp_ratio": 48 / 11, "num_classes": 10}
# on the card: ln_gemm takes K a multiple of 64, so 8 heads of 88 (D = 704, MLP 3072)
TINY_CARD = {**TINY, "embed_dim": 704, "num_heads": 8}
F32_TOL = 1e-4  # relative row error of f32 logits and features, port against reference
BF16_TOL = 0.03  # the same on the card in bf16 (the cell's own readings are ~0.01)
VIT_G_PARAMS = 1_012_230_672  # 1,012.2 M with the k-bias slot of each qkv bias
SEED = 2**31 + 7


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_model(device="cpu", seed=SEED, cfg=TINY):
    model = ft.FinetuneViT(num_classes=cfg["num_classes"], img_size=cfg["img_size"],
                           patch_size=cfg["patch_size"], embed_dim=cfg["embed_dim"],
                           depth=cfg["depth"], heads=cfg["num_heads"],
                           num_frames=cfg["num_frames"], mlp_ratio=cfg["mlp_ratio"]).to(device)
    P = videomae.make_weights(cfg, seed, device)
    model.load_state_dict(convert_v1_state_dict(P), strict=True)
    return model.eval(), P


def _video(B=3, device="cpu", seed=3):
    g = torch.Generator().manual_seed(seed)
    R, T = TINY["img_size"], TINY["num_frames"]
    return torch.randn(B, T, 3, R, R, generator=g).to(device)


def _row_err(got, want):
    return float(((got.float() - want.float()).norm(dim=-1) / want.float().norm(dim=-1)).max())


def test_tiny_model_shape_is_the_vit_g_block():
    model, _ = _tiny_model()
    blk = model.blocks[0]
    assert blk.attn.num_heads * 88 == TINY["embed_dim"]
    assert blk.mlp.fc1.out_features == int(176 * 48 / 11) == 768
    assert blk.norm1.eps == blk.norm2.eps == model.fc_norm.eps == 1e-6
    assert model.embed(_video(1)).shape == (1, 8, 176)  # 2 tubes of 4 patches


@pytest.mark.parametrize("fused", [False, True])
def test_finetune_vit_matches_the_reference(fused):
    """Eager model(video) and the fused eval step (the plain sub-paths on a
    CPU tensor) against the f32 reference: logits and fc_norm features."""
    model, P = _tiny_model()
    video = _video()
    want_logits, want_features = videomae.forward(ref.Numerics("f32"), P, TINY, video)
    features = []
    hook = model.fc_norm.register_forward_hook(lambda m, i, out: features.append(out))
    logits = engine.make_cls_eval_step(model, use_fused=fused)(video)
    hook.remove()
    assert _row_err(logits, want_logits) < F32_TOL
    assert _row_err(features[0], want_features) < F32_TOL


def test_joint_vit_fused_forward_matches_eager():
    """TVTS v1's JointViT at the ViT-g block's head dim (2 heads of 88) with
    per-tube keep sets, through joint_vit_fused_forward and eagerly, held to
    the JAX package's JointViT on the same weights and inputs in f32."""
    import jax

    from tvts_tpu.models import joint_vit as jax_joint_vit
    from tvts_torch.utils.convert import v1_state_dict_from_jax

    arch = dict(img_size=28, patch_size=14, embed_dim=176, depth=2, heads=2, num_frames=4,
                num_classes=5)
    rng = np.random.default_rng(1)
    video = rng.standard_normal((2, 4, 3, 28, 28)).astype(np.float32)
    keep = np.stack([np.stack([rng.permutation(4)[:3] for _ in range(2)])
                     for _ in range(2)]).astype(np.int32)
    jm = jax_joint_vit.JointViT(**arch)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), video, keep)["params"]
    params = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape)
                          .astype(np.float32), params)
    want = np.asarray(jax.jit(lambda p, v, k: jm.apply({"params": p}, v, k))(params, video,
                                                                               keep))
    model = JointViT(**arch)
    sd = v1_state_dict_from_jax({"video_model": params})
    model.load_state_dict({k[len("video_model."):]: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    with torch.no_grad():
        got = fused_forward.joint_vit_fused_forward(model, torch.from_numpy(video),
                                                    torch.from_numpy(keep))
        eager = model(torch.from_numpy(video), torch.from_numpy(keep))
    assert got.shape == want.shape == (2, 1 + 2 * 3, 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    torch.testing.assert_close(got, eager, rtol=1e-5, atol=1e-5)


def test_q_v_bias_fold():
    """VideoMAE's q_bias / v_bias become qkv.bias = [q_bias, 0, v_bias]
    (the k slot zero), under a `module.` prefix too; the rest keep their
    names and values."""
    D = 8
    qb, vb, w = torch.randn(D), torch.randn(D), torch.randn(3 * D, D)
    sd = {"module.blocks.0.attn.q_bias": qb, "module.blocks.0.attn.v_bias": vb,
          "module.blocks.0.attn.qkv.weight": w, "module.head.bias": torch.ones(3)}
    out = convert_v1_state_dict(sd)
    assert sorted(out) == ["blocks.0.attn.qkv.bias", "blocks.0.attn.qkv.weight", "head.bias"]
    assert torch.equal(out["blocks.0.attn.qkv.bias"], torch.cat([qb, torch.zeros(D), vb]))
    assert torch.equal(out["blocks.0.attn.qkv.weight"], w)
    # the fold is what the reference computes: its k rows see no bias
    model, P = _tiny_model()
    qkv_bias = model.blocks[1].attn.qkv.bias
    assert torch.equal(qkv_bias[176:352], torch.zeros(176))
    assert torch.equal(qkv_bias[:176], P["blocks.1.attn.q_bias"])
    assert torch.equal(qkv_bias[352:], P["blocks.1.attn.v_bias"])


def test_vit_giant_has_the_published_sizes_and_count():
    with torch.device("meta"):
        model = ft.vit_giant_patch14_224(num_classes=400)
    blk = model.blocks[0]
    assert (len(model.blocks), model.embed_dim, blk.attn.num_heads) == (40, 1408, 16)
    assert (blk.mlp.fc1.out_features, model.patch_embed.proj.kernel_size) == (6144, (2, 14, 14))
    assert model.pos_table.shape == (2048, 1408) and model.fc_norm is not None
    n = sum(p.numel() for p in model.parameters())
    assert abs(n - VIT_G_PARAMS) <= 100_000, n
    # the published count has no k-bias slot: 1408 fewer a block
    assert n - 40 * 1408 == 1_012_174_352
    with torch.device("meta"):
        base = ft.vit_base_patch16_224()
    assert (len(base.blocks), base.embed_dim, base.blocks[0].mlp.fc1.out_features) == (12, 768,
                                                                                       3072)


def test_cli_builds_the_published_widths_from_the_name():
    from tvts_torch.cli import run_class_finetuning as cli

    args = cli.parse_args(["--data_path", ".", "--model", "vit_giant_patch14_224"])
    assert (args.embed_dim, args.depth, args.heads, args.patch_size, args.mlp_ratio) == (
        1408, 40, 16, 14, 48 / 11)
    args = cli.parse_args(["--data_path", ".", "--embed_dim", "64", "--depth", "2"])
    assert (args.embed_dim, args.depth, args.heads, args.patch_size, args.mlp_ratio) == (
        64, 2, 12, 16, 4.0)
    with pytest.raises(SystemExit):
        cli.parse_args(["--data_path", ".", "--model", "vit_huge"])


def test_text_core_plan_takes_head_dim_88():
    for S, causal in ((77, True), (2048, False), (2047, False)):
        plan = ta.text_core_plan(15, S, 16, 88, causal)
        assert plan["kernel"] == "tma" and "bwd_grid" not in plan
        assert plan["fwd_grid"] == (-(-S // 192), 16, 15)
        assert plan["fwd_smem"] == ta.TEXT_FWD_SMEM[88] <= bk.SMEM_OPTIN
        pairs = {(r, c) for (r0, r1), cols in plan["fwd"] for c0, c1 in cols
                 for r in range(r0, r1) for c in range(c0, c1)}
        need = {(r, c) for r in range(S) for c in range(r + 1 if causal else S)}
        assert pairs >= need and (causal or pairs == need)
    assert ta.TEXT_FWD_SMEM[88] > ta.TEXT_FWD_SMEM[64]
    with pytest.raises(ValueError, match="head dim 80"):
        ta.text_core_plan(2, 2048, 16, 80, False)
    with pytest.raises(ValueError, match="forward only"):
        ta.text_core_plan(2, 2048, 16, 88, False, backward=True)


def test_text_core_plain_at_head_dim_88_is_attention():
    g = torch.Generator().manual_seed(4)
    qkv = torch.randn(2, 37, 3 * 2 * 88, generator=g)
    out, lse = ta.text_core_plain(qkv, 2, causal=False)
    q, k, v = (t.reshape(2, 37, 2, 88).transpose(1, 2) for t in qkv.chunk(3, -1))
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    torch.testing.assert_close(out, want.transpose(1, 2).reshape(2, 37, 176), rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(lse, torch.logsumexp(q @ k.transpose(-1, -2) / 88 ** 0.5, -1))


def test_mlp_block_takes_the_eps():
    """H3's plain path at the given eps; the default is the towers' 1e-5."""
    g = torch.Generator().manual_seed(5)
    D, hidden = 64, 256
    x = torch.randn(2, 5, D, generator=g) * 1e-3  # variance near eps: eps shows
    w = (torch.ones(D), torch.zeros(D), torch.randn(hidden, D, generator=g) / 8,
         torch.zeros(hidden), torch.randn(D, hidden, generator=g) / 16, torch.zeros(D))
    six = bk.fused_mlp_block(x, *w, act="gelu", eps=1e-6)
    torch.testing.assert_close(six, bk.mlp_block_plain(x, *w, "gelu", 1e-6))
    five = bk.fused_mlp_block(x, *w, act="gelu")
    torch.testing.assert_close(five, bk.mlp_block_plain(x, *w, "gelu", 1e-5))
    assert (six - five).abs().max() > 1e-3


def test_cls_eval_records_its_spans():
    model, _ = _tiny_model()
    step = engine.make_cls_eval_step(model, use_fused=True)
    profiling.spans_on(True)
    try:
        profiling.take_spans()
        step(_video(2))
        spans = profiling.take_spans()["spans"]
    finally:
        profiling.spans_on(False)
    assert spans["cls_eval"]["parents"] == {None: 1}
    assert spans["tubelet_stem"]["parents"] == {"cls_eval": 1}
    attn = spans["fused_text_attention_block"]
    assert attn["calls"] == 2 and attn["parents"] == {"cls_eval": 2}
    assert attn["geometry"][0] == {"B": 2, "S": 8, "D": 176, "num_heads": 2, "head_dim": 88,
                                   "causal": False, "eps": 1e-6}
    assert spans["fused_mlp_block"]["geometry"][0]["hidden"] == 768


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qkv(B, S, H, d, seed, dev):
    """Seeded qkv [B, S, 3 H d] in bf16: logits of unit variance."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal((B, S, 3 * H * d)), dtype=torch.bfloat16, device=dev)


CORE_88 = {"cell": (15, 2048, 16, False), "S=2047": (2, 2047, 16, False),
           "S=300 causal": (2, 300, 4, True), "S=77": (3, 77, 2, False)}
CORE_OUT_TOL = 0.02  # max|diff| of out against plain (|out| ~0.05-0.3: P in bf16, sums in f32)
LSE_TOL = 1e-3  # as chip_smoke.TEXT_LSE_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(CORE_88))
def test_text_core_at_head_dim_88_matches_plain(cuda, label):
    """out and lse of the d = 88 core against text_core_plain, a sequence at
    a time; two runs bit-equal; one launch a call."""
    B, S, H, causal = CORE_88[label]
    qkv = _qkv(B, S, H, 88, 88, cuda)
    before = ta.text_core.launches
    out, lse = ta.text_core(qkv, H, causal, with_lse=True)
    again = ta.text_core(qkv, H, causal, with_lse=True)
    torch.cuda.synchronize()
    assert ta.text_core.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    for b in range(B):
        want, want_lse = ta.text_core_plain(qkv[b:b + 1], H, causal)
        assert (out[b].float() - want[0].float()).abs().max().item() < CORE_OUT_TOL
        assert (lse[b] - want_lse[0]).abs().max().item() < LSE_TOL


# sha256 of the d = 64 core's out and lse (bf16 / f32 bytes) on
# chip_smoke.text_core_inputs(B, S, H, 62), as the tree before the d = 88
# core computed them on an H100
CORE_64_SHA256 = {
    "20,1181,8,0": ["48e9a309f4cbabd1daf4cc3b105997e9a0339093f275992a195408f7962fc820",
                   "7c889e46970885ec7a5bd6493e4ebf001c0d778f41354fe78f1805b252c62005"],
    "80,77,8,1": ["daec1ccc0cb5a1f01a5f197443a29595a8bd9ca86cce2444127a4a99d672d989",
                 "70ef1e32e6145359b2aedd1865f948679c5cdbffcc20b2f8a987fc1ca0d37a18"],
    "8,917,16,0": ["62306e44b87161ae61467ee16c0bff416606b9258a28b6f07bde3432b114c231",
                  "4f60510af35ec656788f41de63b922ada025e770526656bdeb908a6e90d57fb6"],
    "32,77,16,1": ["4108d3ea196b519336d1a950f4d567adcf11da65c2da656c850f730348d9792e",
                  "6c1d021ced7829b7fdcfb3e34c8106186e11f8cddfdddb333168c7e3db5365f6"],
    "3,131,4,1": ["d536727a4c7b25a406266cd0f7b44028a7e1c0045041d8ba1a09ebfc94763fda",
                 "65f28433e1c01884051e67995804ed3d14340b84bbecbbcf4ce849ffd8e4f2b0"],
    "3,131,4,0": ["a2d93817229eb5ffb0898179990fd3970202c238ef8fbcabe463c89186dd37cf",
                 "5c0d33289a18cd4d6c2c15239997ffb27e72bad3738d5b5ddcd4611310d09021"],
    "2,300,2,1": ["5fe7b5e6e5d9f58ba8134ac872deb4ebaecde8f4fafda15d9f0bc16a53fdad65",
                 "2c3ea31a193afb90d3b797171db360fdde3dd1f91a096d1e945fb27b22768b31"],
    "1,129,2,0": ["fdc85c62af65c797905b6e24fc13d06f88bf7e4cdd640e82a25873ee02d4ccc4",
                 "deac56af6e682e6eb9c74669a93741ce233fbd8d9fe1390a44c4eb79792970b5"],
    "2,2048,12,0": ["4e130c5f07e7bfd3225f14371a083636f1bd275390a39ba7a81e129434f4b6b4",
                   "2ca3773573623b5d07f50b73b9636a43f770ef0d3be04428da70b78960bfe4ce"],
}


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(CORE_64_SHA256))
def test_text_core_at_head_dim_64_is_unchanged(cuda, label):
    from chip_smoke import text_core_inputs

    B, S, H, causal = (int(v) for v in label.split(","))
    qkv, _ = text_core_inputs(B, S, H, 62, cuda)
    out, lse = ta.text_core(qkv, H, bool(causal), with_lse=True)
    digests = [hashlib.sha256(t.contiguous().cpu().view(torch.uint8).numpy().tobytes()).hexdigest()
               for t in (out, lse)]
    assert digests == CORE_64_SHA256[label]


@pytest.mark.gpu
def test_mlp_block_eps_on_the_card(cuda):
    """H3 at eps 1e-6 on inputs whose variance is near eps: within the H3
    band of the plain path at 1e-6, far from it at 1e-5."""
    rng = np.random.default_rng(6)
    D, hidden = 1408, 6144
    t = lambda *s, std=1.0, base=0.0, dt=torch.bfloat16: torch.tensor(  # noqa: E731
        base + std * rng.standard_normal(s), dtype=dt, device=cuda)
    x = t(2, 300, D, std=1e-3)
    w = (t(D, std=0.1, base=1.0, dt=torch.float32), t(D, std=0.02, dt=torch.float32),
         t(hidden, D, std=D ** -0.5), t(hidden, std=0.02), t(D, hidden, std=hidden ** -0.5),
         t(D, std=0.02))
    got = bk.fused_mlp_block(x, *w, act="gelu", eps=1e-6)
    six, five = (bk.mlp_block_plain(x, *w, "gelu", eps) for eps in (1e-6, 1e-5))
    band = 0.05 * max(1.0, six.float().abs().mean().item() / 0.8)
    assert (got.float() - six.float()).abs().max().item() < band
    assert (got.float() - five.float()).abs().max().item() > band


@pytest.mark.gpu
def test_tiny_model_on_the_kernels(cuda):
    """The fused eval step on bf16 weights against the f32 reference: each
    block launches the core and H3 once, and no eager attention runs."""
    from tvts_torch.models import factory, sort

    model, P = _tiny_model(cuda, cfg=TINY_CARD)
    factory.cast_tower_(model, torch.bfloat16)
    video = _video(3, cuda)
    step = engine.make_cls_eval_step(model, use_fused=True)
    before = ta.text_core.launches, bk.fused_mlp_block.launches
    real, sort.self_attention = sort.self_attention, None  # eager attention would fail
    try:
        logits = step(video)
    finally:
        sort.self_attention = real
    assert (ta.text_core.launches, bk.fused_mlp_block.launches) == (before[0] + 2, before[1] + 2)
    P = {k: v.to(torch.bfloat16).float() if "norm" not in k else v for k, v in P.items()}
    with ref.no_tf32():
        want, _ = videomae.forward(ref.Numerics("f32"), P, TINY_CARD, video)
    assert _row_err(logits, want) < BF16_TOL


@pytest.mark.gpu
def test_head_dim_88_backward_is_refused(cuda):
    qkv = _qkv(1, 300, 2, 88, 9, cuda)
    out, lse = ta.text_core(qkv, 2, False, with_lse=True)
    before = ta.text_core_backward.launches
    with pytest.raises(ValueError, match="forward only"):
        ta.text_core_backward(qkv, out, lse, out, 2, False)
    x = torch.zeros(1, 300, 176, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    w = (torch.ones(176, device=cuda), torch.zeros(176, device=cuda),
         torch.zeros(528, 176, device=cuda, dtype=torch.bfloat16),
         torch.zeros(528, device=cuda, dtype=torch.bfloat16),
         torch.zeros(176, 176, device=cuda, dtype=torch.bfloat16),
         torch.zeros(176, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="forward only"):
        ta.text_subpath(x, *w, num_heads=2, causal=False, eps=1e-6)
    assert ta.text_core_backward.launches == before
