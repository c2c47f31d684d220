"""The H/14 surface of the port on the CPU against the JAX package: the tower
options (LayerScale, PatchDropout, the attentional pooler) with the converter,
an H/14-style TVTSv2 (openclip pool, exact gelu, a 16-head sort head) eager
and through train_apply under the H/14 preset, rematerialisation, and the
optimizer's state dtypes. float32 unless a test says otherwise; every
parameter carries seeded noise (the time attention is zero at init).
Tolerances: forwards atol 3e-5 / rtol 1e-4 (tests/test_fused_forward.py), loss
rtol 1e-5, gradients atol 2e-5 / rtol 2e-3 (tests/test_block_backward.py:
234-240); the optimizer tests state theirs."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_vit import jax_params, port_model, tiny_inputs, tiny_vision
from tests.test_train_step import make_batch
from tests.test_tvtsv2_parity import tiny_config
from tvts_torch.models import configs
from tvts_torch.models.space_time_vit import PatchDropout, SpaceTimeViT
from tvts_torch.ops.fused_forward import space_time_vit_fused_train_forward, train_apply
from tvts_torch.ops.kernel_config import resolve_kernel_config, train_apply_kwargs
from tvts_torch.train.optim import OptimizerConfig, StateDtypeAdamW, label_params, make_optimizer
from tvts_torch.train.step import make_loss_fn, make_train_step
from tvts_torch.utils.convert import state_dict_from_jax

FWD_TOL = dict(atol=3e-5, rtol=1e-4)
LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)
OPT = dict(text_layers=2, text_tune_layers=1)  # the tiny text tower: block 0 frozen


# ---------------------------------------------------------------------------
# tower options
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [
    dict(ls_init=0.1),
    dict(attentional_pool=True, n_queries=6, attn_pooler_heads=4),
    dict(ls_init=0.3, attentional_pool=True, n_queries=5, attn_pooler_heads=2),
], ids=["layerscale", "pooler", "both"])
@pytest.mark.parametrize("pool", ["openai", "openclip"])
def test_tower_options_match_flax(pool, extra):
    kw = tiny_vision(pool, **extra)
    module, params = jax_params(kw)
    video, keep = tiny_inputs(4)
    want_p, want_t = module.apply({"params": params}, jnp.asarray(video), jnp.asarray(keep))
    model = port_model(kw, params)
    with torch.no_grad():
        got_p, got_t = model(torch.from_numpy(video), torch.from_numpy(keep))
        only_p, none = model.pool(torch.zeros(2, 9, 64), need_tokens=False)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **FWD_TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **FWD_TOL)
    assert none is None and only_p.shape == (2, 48)
    if "n_queries" in extra:
        assert got_t.shape == (2, extra["n_queries"] - 1, 48)
    if "ls_init" in extra:
        gamma = model.transformer.resblocks[0].ls_3.gamma
        assert gamma.dtype == torch.float32 and abs(gamma.mean().item() - extra["ls_init"]) < 0.02


def test_patch_dropout_keeps_cls_and_a_seeded_subset():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 11, 8)).astype(np.float32))
    drop = PatchDropout(0.75)
    assert drop.eval()(x) is x  # identity in eval mode
    drop.train()
    out = drop(x, torch.Generator().manual_seed(5))
    num_keep = max(1, int(10 * (1 - 0.75)))
    assert out.shape == (3, 1 + num_keep, 8)
    assert torch.equal(out[:, 0], x[:, 0])  # the CLS token stays first
    for b in range(3):  # every kept row is one of the sample's own patch rows, none twice
        rows = [next(i for i in range(1, 11) if torch.equal(x[b, i], r)) for r in out[b, 1:]]
        assert len(set(rows)) == num_keep
    again = drop(x, torch.Generator().manual_seed(5))
    other = drop(x, torch.Generator().manual_seed(6))
    assert torch.equal(out, again) and not torch.equal(out, other)
    assert PatchDropout(0.999)(x, torch.Generator().manual_seed(1)).shape[1] == 2  # at least one
    assert PatchDropout(0.0).train()(x) is x


def test_patch_dropout_in_the_tower_runs_in_training_only():
    kw = tiny_vision("openclip", patch_dropout=0.5)
    model = SpaceTimeViT(configs.VisionConfig(**kw))
    model.reset_parameters(torch.Generator().manual_seed(0))
    video = torch.from_numpy(tiny_inputs(2)[0])
    with torch.no_grad():
        full = model.eval().embed(video)
        dropped = model.train().embed(video, generator=torch.Generator().manual_seed(3))
    assert full.shape == (2, 1 + 4 * 4, 64)
    assert dropped.shape == (2, 1 + int(16 * 0.5), 64)
    assert not any("patch_dropout" in k for k in model.state_dict())  # no parameters


@functools.cache
def _options_tree():
    """A full flax TVTSv2 tree whose video tower has LayerScale and the pooler."""
    from tvts_tpu.models.tvts_v2 import TVTSv2

    cfg = tiny_config("openclip")
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(
        cfg.vision, ls_init=0.1, attentional_pool=True, n_queries=6, attn_pooler_heads=4))
    batch = make_batch(cfg, B=1)
    params = TVTSv2(cfg).init(jax.random.PRNGKey(0), batch["video"], batch["text_ids"],
                              batch["keep_ind"])["params"]
    return cfg, jax.tree.map(np.asarray, params)


def test_converter_equals_export_state_dict_with_tower_options():
    from tvts_tpu.utils.torch_convert import export_state_dict

    from tvts_torch.models.tvts_v2 import TVTSv2

    cfg, params = _options_tree()
    want = export_state_dict(params, ddp_prefix=False)
    got = state_dict_from_jax(params)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    for name in ("video_model.attn_pool.attn.q_proj_weight",
                 "video_model.attn_pool.attn.in_proj_bias",
                 "video_model.attn_pool.attn.out_proj.weight", "video_model.attn_pool.query",
                 "video_model.attn_pool.ln_k.weight",
                 "video_model.transformer.resblocks.1.ls_2.gamma"):
        assert name in got, name
    port_cfg = configs.TVTSv2Config(
        name="tiny", vision=configs.VisionConfig(**vars(cfg.vision)),
        text=configs.TextConfig(**vars(cfg.text)), sort=configs.SortConfig(**vars(cfg.sort)))
    TVTSv2(port_cfg).load_state_dict({k: torch.from_numpy(v) for k, v in got.items()},
                                     strict=True)
    # a bare video tower converts to the same names without the prefix
    bare = state_dict_from_jax(params["video_model"])
    assert set(bare) == {k[len("video_model."):] for k in got if k.startswith("video_model.")}


def test_fused_paths_leave_layerscale_to_the_eager_tower():
    """As in the JAX package: make_embed_fns(use_fused=True) runs the eager
    video tower for a LayerScale config, and the fused train forward raises."""
    from tvts_torch.eval.embed import make_embed_fns
    from tvts_torch.models.tvts_v2 import TVTSv2

    j = tiny_config("openclip")
    cfg = configs.TVTSv2Config(
        name="tiny", vision=configs.VisionConfig(**dict(vars(j.vision), ls_init=0.1)),
        text=configs.TextConfig(**vars(j.text)), sort=configs.SortConfig(**vars(j.sort)))
    model = TVTSv2(cfg).eval()
    model.reset_parameters(torch.Generator().manual_seed(0))
    video, keep = (torch.from_numpy(a) for a in tiny_inputs(1))
    _, embed_fused = make_embed_fns(model, use_fused=True)
    _, embed_eager = make_embed_fns(model, use_fused=False)
    assert torch.equal(embed_fused(video, keep.long()), embed_eager(video, keep.long()))
    with pytest.raises(NotImplementedError, match="LayerScale"):
        space_time_vit_fused_train_forward(model.video_model, video, keep.long())


# ---------------------------------------------------------------------------
# an H/14-style TVTSv2: openclip pool, exact gelu, 16-head sort head
# ---------------------------------------------------------------------------
def _h14_style_config():
    cfg = tiny_config("openclip")
    return dataclasses.replace(
        cfg, text=dataclasses.replace(cfg.text, act="gelu"),
        sort=dataclasses.replace(cfg.sort, num_heads=16))


def _port_config(j) -> configs.TVTSv2Config:
    return configs.TVTSv2Config(
        name="tiny_h14", vision=configs.VisionConfig(**vars(j.vision)),
        text=configs.TextConfig(**vars(j.text)), sort=configs.SortConfig(**vars(j.sort)))


@functools.cache
def _jax_setup():
    from tvts_tpu.models.tvts_v2 import TVTSv2

    cfg = _h14_style_config()
    batch = make_batch(cfg, B=2)
    model = TVTSv2(cfg)
    params = model.init(jax.random.PRNGKey(0), batch["video"][:1],
                        batch["text_ids"][:cfg.num_clips], batch["keep_ind"][:1])["params"]
    noise = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * noise.normal(size=a.shape).astype(np.float32), params)
    return cfg, model, params, batch


def _port_setup(**model_kw):
    from tvts_torch.models.tvts_v2 import TVTSv2

    cfg, _, params, batch = _jax_setup()
    model = TVTSv2(_port_config(cfg), **model_kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()},
                          strict=True)
    return model.train(), {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_grads(model, loss) -> dict:
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: np.zeros(p.shape, np.float32) if g is None else g.numpy()
            for (n, p), g in zip(named, grads)}


def _assert_grads_match(got: dict, jax_grads):
    want = state_dict_from_jax(jax_grads)
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, **GRAD_TOL, err_msg=name)


def test_h14_style_forward_loss_and_grads_match_jax():
    from tvts_tpu.train.step import make_loss_fn as jax_make_loss_fn

    _, jmodel, params, batch = _jax_setup()
    want = jmodel.apply({"params": params}, batch["video"], batch["text_ids"], batch["keep_ind"])
    (l_j, _), g_j = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel), has_aux=True))(
        params, batch)
    model, tbatch = _port_setup()
    got = model(tbatch["video"], tbatch["text_ids"], tbatch["keep_ind"])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **FWD_TOL)
    loss, _ = make_loss_fn()(model, tbatch)
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=LOSS_RTOL)
    _assert_grads_match(_port_grads(model, loss), g_j)


def test_h14_preset_train_apply_matches_jax_fused_apply():
    """train_apply under the H/14 "best" preset (H5 space, the checkpointed
    plain time sub-path, H7 text with a frozen block, plain sort head and MLP;
    plain versions on the CPU) against make_fused_train_apply with the same
    preset, Pallas in interpret mode."""
    from tvts_tpu.ops.fused_forward import make_fused_train_apply
    from tvts_tpu.ops.kernel_config import resolve_kernel_config as jax_resolve
    from tvts_tpu.train.step import make_loss_fn as jax_make_loss_fn

    cfg, jmodel, params, batch = _jax_setup()
    v = cfg.vision
    ocfg = OptimizerConfig(**OPT)
    kcfg = resolve_kernel_config("TVTSv2_H_14", {"preset": "best"}, {})
    assert kcfg == jax_resolve("TVTSv2_H_14", {"preset": "best"}, {})
    kwargs = train_apply_kwargs(kcfg, ocfg)
    assert kwargs == dict(space_kernel=True, time_kernel=False, mlp_kernel=False,
                          mlp_save_hidden=False, text_kernel=True, sort_kernel=False,
                          text_tune_from=1)
    apply_fn = make_fused_train_apply(
        jmodel, cfg, num_frames=v.num_frames, n_keep=v.n_keep, dtype=jnp.float32,
        **dict(kcfg, time_chunk=8, interpret=True), text_tune_from=ocfg.text_tune_from)
    (l_j, _), g_j = jax.value_and_grad(jax_make_loss_fn(jmodel, apply_fn=apply_fn),
                                       has_aux=True)(params, batch)
    model, tbatch = _port_setup()
    loss, _ = make_loss_fn(apply_fn=lambda m, b: train_apply(m, b, **kwargs))(model, tbatch)
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=LOSS_RTOL)
    got = _port_grads(model, loss)
    assert not got["text_model.resblocks.0.mlp.c_fc.weight"].any()  # the frozen block
    _assert_grads_match(got, g_j)


def test_remat_equals_no_remat():
    """remat=True (torch.utils.checkpoint per block of both towers) changes
    neither the outputs nor the gradients (tests/test_h14_style_training.py:42
    holds the outputs at atol 1e-6; recomputation in float32 repeats the same
    operations, so the port's are bit-equal)."""
    plain, batch = _port_setup()
    remat, _ = _port_setup(remat=True)
    assert remat.remat and remat.video_model.remat and not plain.video_model.remat
    out_p = plain(batch["video"], batch["text_ids"], batch["keep_ind"])
    out_r = remat(batch["video"], batch["text_ids"], batch["keep_ind"])
    for a, b in zip(out_p, out_r):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6, rtol=0)
    g_p = _port_grads(plain, make_loss_fn()(plain, batch)[0])
    g_r = _port_grads(remat, make_loss_fn()(remat, batch)[0])
    for name in g_p:
        np.testing.assert_allclose(g_r[name], g_p[name], atol=1e-7, rtol=1e-6, err_msg=name)


def test_build_model_passes_remat_and_use_pallas():
    from tvts_torch.models.factory import build_model

    _, model = build_model("TVTSv2_B_32", device="cpu", remat=True, use_pallas=True,
                           eval_mode=False)
    assert model.remat and model.video_model.remat and model.video_model.use_pallas
    assert model.training


# ---------------------------------------------------------------------------
# optimizer: H/14 labels and the state dtypes
# ---------------------------------------------------------------------------
def test_h14_text_labels_freeze_eighteen_blocks():
    ocfg = OptimizerConfig(text_layers=24, text_tune_layers=6)
    assert ocfg.text_tune_from == 18
    names = [f"text_model.resblocks.{i}.mlp.c_fc.weight" for i in range(24)]

    class Named(torch.nn.Module):
        def named_parameters(self, *a, **k):
            return [(n, None) for n in names + ["video_model.transformer.resblocks.0.ls_3.gamma"]]

    labels = label_params(Named(), ocfg)
    assert [labels[n] for n in names] == ["frozen"] * 18 + ["clip_decay"] * 6
    assert labels["video_model.transformer.resblocks.0.ls_3.gamma"] == "new_decay"


def _two_optimizer_steps(param_dtype, atol):
    """Two steps of the same gradients through the port's optimizer and optax
    with mu_dtype="bfloat16", the LR decaying after step 0; returns after
    checking every parameter and the first moment's dtype."""
    from tvts_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
    from tvts_tpu.train.optim import make_optimizer as jax_make_optimizer

    kw = dict(OPT, lr_new=1e-3, lr_clip=1e-4, schedule=(1,), steps_per_epoch=1,
              mu_dtype="bfloat16")
    _, _, params, _ = _jax_setup()
    model, _ = _port_setup()
    jdtype = jnp.bfloat16 if param_dtype == torch.bfloat16 else jnp.float32
    jparams = jax.tree.map(lambda a: jnp.asarray(a).astype(jdtype), params)
    model = model.to(param_dtype)
    ocfg = OptimizerConfig(**kw)
    optimizer = make_optimizer(model, ocfg)
    assert isinstance(optimizer, StateDtypeAdamW)
    tx = jax_make_optimizer(jparams, JaxOptimizerConfig(**kw))
    state = tx.init(jparams)
    update = jax.jit(tx.update)
    rng = np.random.default_rng(2)
    from tvts_torch.train.optim import milestone_scale_fn

    scale = milestone_scale_fn(ocfg)
    for step in range(2):
        grads = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)).astype(jdtype),
            params)
        updates, state = update(grads, state, jparams)
        jparams = jax.tree.map(lambda p, u: (p + u).astype(p.dtype), jparams, updates)
        port_grads = state_dict_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), grads))
        for group in optimizer.param_groups:
            group["lr"] = group["base_lr"] * scale(step)
        for name, p in model.named_parameters():
            p.grad = (torch.from_numpy(port_grads[name]).to(param_dtype)
                      if p.requires_grad else None)
        optimizer.step()
    want = state_dict_from_jax(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams))
    for name, p in model.named_parameters():
        assert p.dtype == param_dtype
        np.testing.assert_allclose(p.detach().float().numpy(), want[name], atol=atol, rtol=0,
                                   err_msg=name)
    for p, st in optimizer.state.items():
        assert st["mu"].dtype == torch.bfloat16 and st["nu"].dtype == param_dtype
    assert len(optimizer.state) == sum(p.requires_grad for p in model.parameters())


def test_mu_dtype_bfloat16_two_steps_match_optax():
    """f32 parameters, bf16 first moment: the update is taken from the
    un-rounded moment, so only the second step sees bf16 state (relative
    2^-9 on 0.9 * mu of a step of size lr): atol 2e-5 at lr 1e-3, against
    1e-6 for f32 state (tests/test_torch_train.py)."""
    _two_optimizer_steps(torch.float32, atol=2e-5)


def test_bf16_state_recipe_two_steps_match_optax():
    """bf16 parameters and first moment (tools/train_bench.py --bf16_state):
    every operation rounds to bf16, the parameters have 8 bits of mantissa and
    the two frameworks may round an intermediate differently by one ulp:
    atol one bf16 ulp of the largest parameters (2^-7 at |p| in [1, 2))."""
    _two_optimizer_steps(torch.bfloat16, atol=2 ** -7)


def test_two_train_steps_with_bf16_first_moment_stay_finite_and_freeze():
    model, batch = _port_setup()
    ocfg = OptimizerConfig(**OPT, mu_dtype="bfloat16")
    optimizer = make_optimizer(model, ocfg)
    step = make_train_step(model, optimizer, ocfg)
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith("text_model.resblocks.0.")}
    for _ in range(2):
        assert np.isfinite(step(batch)["loss"].item())
    for n, p in model.named_parameters():
        if n in frozen:
            assert torch.equal(p.detach(), frozen[n]), n
