"""The port's training step on the CPU against the JAX package, on
tests/test_tvtsv2_parity.py's tiny config and tests/test_train_step.py's
batch: the losses, the optimizer's groups and AdamW steps, the loss and every
gradient of the eager forward and of the kernel path (the kernels' plain
versions, frozen text blocks through `tune_from`) against JAX's XLA and Pallas
(interpret) paths, two optimizer steps with frozen text blocks, and the kernel
config. float32; every parameter carries seeded noise (the time attention is
zero at init). Tolerances: loss rtol 1e-5, gradients atol 2e-5 / rtol 2e-3
(tests/test_block_backward.py:234-240), AdamW against optax on the same
gradients atol 1e-6; the parameters after two train steps as each assertion
states, from the size of Adam's step."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_train_step import make_batch
from tests.test_tvtsv2_parity import tiny_config
from tvts_torch.models import configs
from tvts_torch.ops.fused_forward import train_apply
from tvts_torch.ops.kernel_config import resolve_kernel_config, train_apply_kwargs
from tvts_torch.ops.losses import norm_softmax_loss, sort_accuracy, sort_loss
from tvts_torch.train.optim import (
    OptimizerConfig,
    freeze_mask,
    label_params,
    make_optimizer,
    milestone_scale_fn,
)
from tvts_torch.train.step import make_eval_step, make_loss_fn, make_train_step
from tvts_torch.utils.convert import state_dict_from_jax

LOSS_RTOL = 1e-5
GRAD_TOL = dict(atol=2e-5, rtol=2e-3)
# the tiny text tower has 2 blocks: block 0 frozen, block 1 (the EOT-only one) tuned
OPT = dict(text_layers=2, text_tune_layers=1)


def port_config() -> configs.TVTSv2Config:
    """tiny_config("openai") in the port's dataclasses."""
    j = tiny_config("openai")
    return configs.TVTSv2Config(
        name="tiny", vision=configs.VisionConfig(**vars(j.vision)),
        text=configs.TextConfig(**vars(j.text)), sort=configs.SortConfig(**vars(j.sort)))


@functools.cache
def _jax_setup():
    """(flax TVTSv2, params with seeded noise, numpy batch of 2 clips)."""
    from tvts_tpu.models.tvts_v2 import TVTSv2

    cfg = tiny_config("openai")
    batch = make_batch(cfg, B=2)
    model = TVTSv2(cfg)
    params = model.init(jax.random.PRNGKey(0), batch["video"][:1],
                        batch["text_ids"][:cfg.num_clips], batch["keep_ind"][:1])["params"]
    noise = np.random.default_rng(1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * noise.normal(size=a.shape).astype(np.float32), params)
    return model, params, batch


def port_setup():
    """(the port's TVTSv2 with the JAX weights, torch batch)."""
    from tvts_torch.models.tvts_v2 import TVTSv2

    _, params, batch = _jax_setup()
    model = TVTSv2(port_config())
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()},
                          strict=True)
    return model.train(), {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_name(path, leaf) -> str:
    """The port's name of the JAX leaf at `path` (through the converter)."""
    tree = leaf
    for key in reversed(path):
        tree = {key: tree}
    return next(iter(state_dict_from_jax(tree)))


def _jax_flat(tree) -> dict:
    """{port name: leaf} of a JAX tree shaped like the params."""
    _, params, _ = _jax_setup()
    leaves = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    return {_port_name(tuple(p.key for p in path), np.asarray(leaf)): leaves[path]
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _port_grads(model, loss) -> dict:
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {n: np.zeros(p.shape, np.float32) if g is None else g.numpy()
            for (n, p), g in zip(named, grads)}


def _assert_grads_match(got: dict, jax_grads):
    want = state_dict_from_jax(jax_grads)  # the converter transposes kernels as it does weights
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, **GRAD_TOL, err_msg=name)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(6, 6), (4, 7), (7, 3)])
def test_losses_match_jax(shape):
    from tvts_tpu.ops import losses as jl

    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    sim = rng.uniform(-1, 1, size=shape).astype(np.float32)
    pred = rng.standard_normal((shape[0], 4, 4)).astype(np.float32)
    labels = np.tile(np.arange(4), (shape[0], 1))
    labels[0] = (2, 0, 1, 3)
    pred[1] = np.eye(4) * 5  # one sample sorted right
    np.testing.assert_allclose(norm_softmax_loss(torch.from_numpy(sim)).item(),
                               float(jl.norm_softmax_loss(jnp.asarray(sim))), rtol=LOSS_RTOL)
    np.testing.assert_allclose(sort_loss(torch.from_numpy(pred), torch.from_numpy(labels)).item(),
                               float(jl.sort_loss(jnp.asarray(pred), jnp.asarray(labels))),
                               rtol=LOSS_RTOL)
    assert sort_accuracy(torch.from_numpy(pred), torch.from_numpy(labels)).item() == \
        float(jl.sort_accuracy(jnp.asarray(pred), jnp.asarray(labels))) > 0


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------
def test_label_params_match_jax_group_for_group():
    from tvts_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
    from tvts_tpu.train.optim import label_params as jax_label_params

    _, params, _ = _jax_setup()
    model, _ = port_setup()
    want = _jax_flat(jax_label_params(params, JaxOptimizerConfig(**OPT)))
    got = label_params(model, OptimizerConfig(**OPT))
    assert got == want
    assert {"new_decay", "new_nodecay", "clip_decay", "clip_nodecay", "frozen"} == set(got.values())
    assert freeze_mask(model, OptimizerConfig(**OPT))["text_model.resblocks.0.attn.in_proj_weight"]


def test_adamw_two_steps_match_optax_across_a_milestone():
    """The same gradients through the port's 4-group AdamW and the JAX
    package's optax transform, the LR decaying after step 0."""
    from tvts_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
    from tvts_tpu.train.optim import make_optimizer as jax_make_optimizer

    kw = dict(OPT, lr_new=1e-3, lr_clip=1e-4, schedule=(1,), steps_per_epoch=1)
    _, params, _ = _jax_setup()
    model, _ = port_setup()
    optimizer = make_optimizer(model, OptimizerConfig(**kw))
    scale = milestone_scale_fn(OptimizerConfig(**kw))
    tx = jax_make_optimizer(params, JaxOptimizerConfig(**kw))
    state, jparams = tx.init(params), params
    update = jax.jit(tx.update)
    rng = np.random.default_rng(2)
    for step in range(2):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        updates, state = update(grads, state, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        port_grads = state_dict_from_jax(grads)
        for group in optimizer.param_groups:
            group["lr"] = group["base_lr"] * scale(step)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(port_grads[name]) if p.requires_grad else None
        optimizer.step()
    want = state_dict_from_jax(jparams)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=1e-6, rtol=0,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# loss and gradients of the eager forward and of the kernel path
# ---------------------------------------------------------------------------
def test_eager_loss_and_grads_match_jax():
    from tvts_tpu.train.step import make_loss_fn as jax_make_loss_fn

    jmodel, params, batch = _jax_setup()
    (l_j, aux_j), g_j = jax.jit(jax.value_and_grad(jax_make_loss_fn(jmodel), has_aux=True))(
        params, batch)
    model, tbatch = port_setup()
    loss, aux = make_loss_fn()(model, tbatch)
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=LOSS_RTOL)
    for k in ("loss_ct", "loss_ce", "sort_acc"):
        np.testing.assert_allclose(aux[k].item(), float(aux_j[k]), rtol=LOSS_RTOL, atol=1e-7)
    _assert_grads_match(_port_grads(model, loss), g_j)


def test_kernel_path_loss_and_grads_match_jax_fused_apply():
    """train_apply (plain versions on the CPU; block 0 of the text tower
    frozen) against make_fused_train_apply with the B/16 best preset's modes,
    Pallas in interpret mode: frozen text parameters get no gradient in
    either (zero in JAX, none in the port)."""
    from tvts_tpu.ops.fused_forward import make_fused_train_apply
    from tvts_tpu.train.step import make_loss_fn as jax_make_loss_fn

    jmodel, params, batch = _jax_setup()
    cfg = tiny_config("openai")
    v = cfg.vision
    tune_from = OptimizerConfig(**OPT).text_tune_from
    apply_fn = make_fused_train_apply(
        jmodel, cfg, num_frames=v.num_frames, n_keep=v.n_keep, dtype=jnp.float32,
        time_chunk=8, space_mode="pallas_v10", space_fpp=4, time_mode="pallas_tps",
        text_mode="pallas", text_tune_from=tune_from, sort_mode="pallas", interpret=True)
    loss_j = jax_make_loss_fn(jmodel, apply_fn=apply_fn)
    (l_j, _), g_j = jax.value_and_grad(loss_j, has_aux=True)(params, batch)
    model, tbatch = port_setup()
    loss, _ = make_loss_fn(apply_fn=lambda m, b: train_apply(m, b, text_tune_from=tune_from))(
        model, tbatch)
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=LOSS_RTOL)
    got = _port_grads(model, loss)
    assert not got["text_model.resblocks.0.mlp.c_fc.weight"].any()
    _assert_grads_match(got, g_j)


# ---------------------------------------------------------------------------
# optimizer steps
# ---------------------------------------------------------------------------
def test_two_train_steps_match_jax_with_frozen_blocks():
    from tvts_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
    from tvts_tpu.train.optim import freeze_mask as jax_freeze_mask
    from tvts_tpu.train.optim import make_optimizer as jax_make_optimizer
    from tvts_tpu.train.step import create_train_state, make_train_step as jax_make_train_step

    kw = dict(OPT, lr_new=1e-3, lr_clip=1e-4, schedule=(1,), steps_per_epoch=1)
    jmodel, params, batch = _jax_setup()
    tx = jax_make_optimizer(params, JaxOptimizerConfig(**kw))
    jstep = jax_make_train_step(jmodel, tx, donate=False,
                                freeze_mask=jax_freeze_mask(params, JaxOptimizerConfig(**kw)))
    state = create_train_state(params, tx)
    model, tbatch = port_setup()
    ocfg = OptimizerConfig(**kw)
    step = make_train_step(model, make_optimizer(model, ocfg), ocfg)
    frozen = {n for n, f in freeze_mask(model, ocfg).items() if f}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for _ in range(2):
        state, aux_j = jstep(state, batch)
        aux = step(tbatch)
        np.testing.assert_allclose(aux["loss"].item(), float(aux_j["loss"]), rtol=LOSS_RTOL)
    want = state_dict_from_jax(state.params)
    for name, p in model.named_parameters():
        got = p.detach().numpy()
        if name in frozen:
            assert torch.equal(p.detach(), before[name]), name
        if name.endswith(("qkv.bias", "in_proj_bias")):
            # the key bias's gradient is zero in exact arithmetic (softmax
            # ignores a shift of a query's logits), so Adam steps it by
            # lr * noise / (|noise| + eps) in either sign: at most lr per step
            k = slice(len(got) // 3, 2 * len(got) // 3)
            lr = kw["lr_new"] if label_params(model, ocfg)[name].startswith("new") \
                else kw["lr_clip"]
            np.testing.assert_allclose(got[k], want[name][k], atol=2 * 2 * lr, rtol=0)
            got, want[name] = np.delete(got, k), np.delete(want[name], k)
        # elsewhere the two gradients agree to ~1e-8 (f32 summation order),
        # which moves Adam's step lr * g / (|g| + eps) by <= lr * 1e-8 / eps
        np.testing.assert_allclose(got, want[name], atol=2 * 1e-2 * kw["lr_new"], rtol=0,
                                   err_msg=name)


def test_eval_step_returns_the_loss_fn_values():
    model, tbatch = port_setup()
    out = make_eval_step(model)(tbatch)
    _, aux = make_loss_fn()(model, tbatch)
    assert out["text_emb"].shape == out["video_emb"].shape == (2, 48)
    torch.testing.assert_close(out["loss"], aux["loss"])
    torch.testing.assert_close(out["sort_acc"], aux["sort_acc"])


# ---------------------------------------------------------------------------
# kernel config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["TVTSv2_B_16", "TVTSv2_B_32", "TVTSv2_H_14"])
@pytest.mark.parametrize("kernels_cfg,env", [
    ({}, {}), ({"preset": "best"}, {}), ({"preset": "best", "sfpp": 0, "space_mode": "xla"}, {}),
    ({"text_mode": "pallas"}, {"TVTS_TIME_MODE": "pallas_v3", "TVTS_SFPP": "3"})])
def test_resolve_kernel_config_matches_jax(arch, kernels_cfg, env):
    from tvts_tpu.ops.kernel_config import resolve_kernel_config as jax_resolve

    assert resolve_kernel_config(arch, kernels_cfg, env) == jax_resolve(arch, kernels_cfg, env)


def test_train_apply_kwargs_map_every_mode():
    ocfg = OptimizerConfig()
    best = train_apply_kwargs(resolve_kernel_config("TVTSv2_B_16", {"preset": "best"}, {}), ocfg)
    assert best == dict(space_kernel=True, time_kernel=True, mlp_kernel=False,
                        mlp_save_hidden=False, text_kernel=True, sort_kernel=True,
                        text_tune_from=9)
    h14 = train_apply_kwargs(resolve_kernel_config("TVTSv2_H_14", {}, {}), ocfg)
    assert (h14["time_kernel"], h14["text_kernel"], h14["text_tune_from"]) == (False, False, None)
    for mode in ("pallas", "pallas_ps", "pallas_v2", "pallas_v5", "pallas_v10", "pallas_v10r"):
        kcfg = resolve_kernel_config("TVTSv2_B_16", {"space_mode": mode}, {})
        assert train_apply_kwargs(kcfg)["space_kernel"]
    assert train_apply_kwargs(  # H8
        resolve_kernel_config("TVTSv2_B_16", {"mlp_mode": "pallas"}, {}))["mlp_kernel"]
    with pytest.raises(ValueError, match="time_mode"):
        train_apply_kwargs(resolve_kernel_config("TVTSv2_B_16", {"time_mode": "pallas_v9"}, {}))
