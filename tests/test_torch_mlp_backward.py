"""H8, the port's differentiable MLP sub-path, on the CPU (where its autograd
Function runs the plain forward and the plain backward) against the JAX
package's two custom VJPs with the Pallas kernels in interpret mode, as
tests/test_block_backward.py:90,352 runs them: make_mlp_subpath (row-major,
recomputing the hidden) and make_mlp_subpath_v7 (d-major, saving it), the
latter through a layout transpose. float32, loss sum(sin(f)), forward atol
3e-5 / rtol 1e-4, gradients atol 5e-4 / rtol 2e-3
(tests/test_block_backward.py:61). Then the train step with mlp_mode="pallas"
against JAX's (loss rtol 1e-5, gradients atol 2e-5 / rtol 2e-3), and the
kernel config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train import (
    OPT,
    _assert_grads_match,
    _jax_setup,
    _port_grads,
    port_setup,
)
from tests.test_tvtsv2_parity import tiny_config
from tvts_torch.ops import block_backward as bb
from tvts_torch.ops import block_kernels as bk
from tvts_torch.ops.fused_forward import train_apply
from tvts_torch.ops.kernel_config import resolve_kernel_config, train_apply_kwargs
from tvts_torch.train.optim import OptimizerConfig
from tvts_torch.train.step import make_loss_fn

FWD_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=2e-3)
MATRICES = (3, 5)  # wfc, wproj among the arguments


def _args(seed, B, S, D, Hd):
    """The JAX package's arguments ([in, out] matrices), drawn as
    tests/test_block_backward.py::test_mlp_subpath_grads_gelu draws them."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, D)).astype(np.float32),
            rng.normal(size=(D,)).astype(np.float32),
            rng.normal(size=(D,)).astype(np.float32),
            (rng.normal(size=(D, Hd)) * 0.07).astype(np.float32),
            (rng.normal(size=(Hd,)) * 0.07).astype(np.float32),
            (rng.normal(size=(Hd, D)) * 0.07).astype(np.float32),
            (rng.normal(size=(D,)) * 0.07).astype(np.float32))


def _torch_args(args):
    """The port's arguments: nn.Linear [out, in] matrices, leaves that need grad."""
    return [torch.from_numpy(np.ascontiguousarray(a.T if i in MATRICES else a)).requires_grad_()
            for i, a in enumerate(args)]


def _compare(jax_f, act, save_hidden, args):
    jargs = [jnp.asarray(a) for a in args]
    want = jax_f(*jargs)
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_f(*a))), argnums=tuple(range(7)))(*jargs)
    targs = _torch_args(args)
    before = bb.mlp_subpath.launches, bb.mlp_subpath_backward.launches
    got = bb.mlp_subpath(*targs, act, save_hidden)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    torch.sin(got).sum().backward()
    assert (bb.mlp_subpath.launches, bb.mlp_subpath_backward.launches) == before  # CPU
    for i, (t, g) in enumerate(zip(targs, grads)):
        tg = t.grad.numpy().T if i in MATRICES else t.grad.numpy()
        np.testing.assert_allclose(tg, np.asarray(g), **GRAD_TOL, err_msg=f"argument {i}")


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_subpath_matches_jax_recomputing_vjp(act):
    from tvts_tpu.ops.pallas_block_attention import make_mlp_subpath

    _compare(make_mlp_subpath(act=act, chunk=16, interpret=True), act, False,
             _args(1, 2, 21, 32, 128))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_mlp_subpath_matches_jax_saving_vjp_v7(act):
    from tvts_tpu.ops.pallas_block_backward import make_mlp_subpath_v7

    B, T, N, D, Hd = 2, 3, 5, 32, 128
    f7 = make_mlp_subpath_v7(act=act, interpret=True)

    def f(x, *w):  # row-major tokens through the d-major kernel
        xT = jnp.swapaxes(x[:, 1:].reshape(B, T, N, D), -1, -2)
        oT, ocls = f7(xT, x[:, :1], *w)
        return jnp.concatenate([ocls, jnp.swapaxes(oT, -1, -2).reshape(B, T * N, D)], axis=1)

    _compare(f, act, True, _args(11, B, 1 + T * N, D, Hd))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_plain_mlp_backward_is_the_functions_gradient(act):
    """mlp_subpath_backward_plain (what the kernel is held against on the
    card) returns the Function's CPU gradients, in argument order, for either
    save_hidden; and the Function's forward is mlp_block_plain."""
    args = _torch_args(_args(5, 2, 9, 16, 64))
    g = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 9, 16)).astype(np.float32))
    got = bb.mlp_subpath_backward_plain(g, *args, act)
    assert len(got) == 7
    for save_hidden in (False, True):
        want = bb.vjp(lambda *a: bb.mlp_subpath(*a, act, save_hidden), g, args)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(bb.mlp_subpath(*args, act), bk.mlp_block_plain(*args, act),
                               rtol=0, atol=0)


def test_mlp_subpath_raises_on_what_it_does_not_take():
    args = [t.detach() for t in _torch_args(_args(7, 1, 5, 16, 64))]
    with pytest.raises(ValueError, match="activation"):
        bb.mlp_subpath(*args, "relu")
    with pytest.raises(ValueError, match="no kernel"):  # no fallback off the CPU and the card
        bb.mlp_subpath(*[t.to("meta") for t in args])


@pytest.mark.parametrize("layout", ["row", "dmajor"])
def test_train_step_with_mlp_mode_pallas_matches_jax(layout):
    """train_apply with the MLP sub-paths on H8 (plain versions on the CPU)
    against make_fused_train_apply with mlp_mode="pallas" (row layout: the
    recomputing kernels) and with layout="dmajor" (the v7 tower: every
    sub-path a kernel, the MLP saving its hidden), Pallas in interpret mode."""
    from tvts_tpu.ops.fused_forward import make_fused_train_apply
    from tvts_tpu.train.step import make_loss_fn as jax_make_loss_fn

    jmodel, params, batch = _jax_setup()
    cfg = tiny_config("openai")
    v = cfg.vision
    kcfg = resolve_kernel_config("TVTSv2_B_16", {"mlp_mode": "pallas", "layout": layout}, {})
    kwargs = train_apply_kwargs(kcfg, OptimizerConfig(**OPT))
    assert kwargs["mlp_kernel"] and kwargs["mlp_save_hidden"] == (layout == "dmajor")
    apply_fn = make_fused_train_apply(
        jmodel, cfg, num_frames=v.num_frames, n_keep=v.n_keep, dtype=jnp.float32,
        **dict(kcfg, time_chunk=8, interpret=True))
    (l_j, _), g_j = jax.value_and_grad(jax_make_loss_fn(jmodel, apply_fn=apply_fn),
                                       has_aux=True)(params, batch)
    model, tbatch = port_setup()
    loss, _ = make_loss_fn(apply_fn=lambda m, b: train_apply(m, b, **kwargs))(model, tbatch)
    np.testing.assert_allclose(loss.item(), float(l_j), rtol=1e-5)
    _assert_grads_match(_port_grads(model, loss), g_j)


def test_train_apply_kwargs_accept_every_mlp_mode_and_layout():
    base = dict(space_kernel=True, time_kernel=True, mlp_kernel=False, mlp_save_hidden=False,
                text_kernel=False, sort_kernel=False, text_tune_from=None)
    assert train_apply_kwargs(resolve_kernel_config("TVTSv2_B_16", {}, {})) == base
    assert train_apply_kwargs(resolve_kernel_config(
        "TVTSv2_B_16", {"mlp_mode": "pallas"}, {})) == dict(base, mlp_kernel=True)
    assert train_apply_kwargs(resolve_kernel_config(  # d-major: every sub-path a kernel
        "TVTSv2_H_14", {"layout": "dmajor"}, {})) == dict(base, mlp_kernel=True,
                                                          mlp_save_hidden=True)
    assert train_apply_kwargs(resolve_kernel_config(
        "TVTSv2_B_16", {}, {"TVTS_MLP_MODE": "pallas"}))["mlp_kernel"]
    with pytest.raises(ValueError, match="mlp_mode"):
        train_apply_kwargs(resolve_kernel_config("TVTSv2_B_16", {"mlp_mode": "fused"}, {}))
    with pytest.raises(ValueError, match="layout"):
        train_apply_kwargs(resolve_kernel_config("TVTSv2_B_16", {"layout": "col"}, {}))
