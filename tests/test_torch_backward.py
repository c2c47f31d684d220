"""The port's differentiable sub-paths H6 (time), H5 (space) and H7 (text /
sort head) on the CPU, where their autograd Functions run the plain forward
and the plain backward, against the JAX package's custom VJPs with the Pallas
kernels in interpret mode, as tests/test_block_backward.py runs them: float32,
loss sum(sin(f)), forward atol 3e-5 / rtol 1e-4, gradients atol 5e-4 /
rtol 2e-3 (tests/test_block_backward.py:61)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvts_torch.ops import block_backward as bb
from tvts_torch.ops import text_attention as ta

FWD_TOL = dict(atol=3e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-4, rtol=2e-3)
MATRICES = (2, 4)  # wqkv, wproj among the weights


def _args(seed, B, S, D, with_base):
    """The JAX package's arguments ([in, out] matrices) from a numpy seed, as
    tests/test_block_backward.py::_attn_args draws them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    base = rng.normal(size=(B, S, D)).astype(np.float32)
    ln_s = rng.normal(size=(D,)).astype(np.float32)
    ln_b = rng.normal(size=(D,)).astype(np.float32)
    wqkv = (rng.normal(size=(D, 3 * D)) * 0.07).astype(np.float32)
    bqkv = (rng.normal(size=(3 * D,)) * 0.07).astype(np.float32)
    wproj = (rng.normal(size=(D, D)) * 0.07).astype(np.float32)
    bproj = (rng.normal(size=(D,)) * 0.07).astype(np.float32)
    return (x, base) if with_base else (x,), (ln_s, ln_b, wqkv, bqkv, wproj, bproj)


def _torch_args(acts, weights):
    """The port's arguments: nn.Linear [out, in] matrices, leaves that need grad."""
    ln_s, ln_b, wqkv, bqkv, wproj, bproj = weights
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in (*acts, ln_s, ln_b, wqkv.T, bqkv, wproj.T, bproj)]


def _compare(jax_f, port_f, acts, weights, frozen=False):
    """Forward and sum(sin(f)) gradients of the JAX custom VJP and the port's
    Function; the port's matrix gradients are transposed back to [in, out]."""
    jargs = [jnp.asarray(a) for a in (*acts, *weights)]
    n = len(jargs)
    want = jax_f(*jargs)
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_f(*a))), argnums=tuple(range(n)))(*jargs)
    targs = _torch_args(acts, weights)
    got = port_f(*targs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD_TOL)
    torch.sin(got).sum().backward()
    offset = len(acts)
    for i, (t, g) in enumerate(zip(targs, grads)):
        if frozen and i >= offset:
            assert t.grad is None, i  # frozen: no weight gradient at all
            assert not np.any(np.asarray(g)), i
            continue
        tg = t.grad.numpy()
        if i - offset in MATRICES:
            tg = tg.T
        np.testing.assert_allclose(tg, np.asarray(g), **GRAD_TOL, err_msg=f"argument {i}")


def test_time_subpath_matches_jax_custom_vjp():
    from tvts_tpu.ops.pallas_block_backward import make_time_subpath

    B, T, N, D, H = 2, 3, 5, 32, 4
    acts, weights = _args(21, B, 1 + T * N, D, with_base=False)
    before = bb.time_subpath.launches, bb.time_subpath_backward.launches
    _compare(make_time_subpath(T, N, H, chunk=4, save_probs=True, interpret=True),
             lambda *a: bb.time_subpath(*a, T, H), acts, weights)
    assert (bb.time_subpath.launches, bb.time_subpath_backward.launches) == before  # CPU


def test_space_subpath_matches_jax_custom_vjp():
    from tvts_tpu.ops.pallas_block_backward import make_space_subpath_v10

    B, T, N, D, H = 2, 4, 5, 32, 4
    acts, weights = _args(22, B, 1 + T * N, D, with_base=True)
    before = bb.space_subpath.launches, bb.space_subpath_backward.launches
    _compare(make_space_subpath_v10(T, N, H, fpp=4, interpret=True),
             lambda *a: bb.space_subpath(*a, T, H), acts, weights)
    assert (bb.space_subpath.launches, bb.space_subpath_backward.launches) == before


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("causal,eps", [(True, 1e-5), (False, 1e-6)])
def test_text_subpath_matches_jax_custom_vjp(causal, eps, frozen):
    from tvts_tpu.ops.pallas_text_attention import make_text_subpath

    B, S, D, H = 3, 13, 32, 4
    acts, weights = _args(23 + 2 * causal + frozen, B, S, D, with_base=False)
    before = ta.text_subpath_backward.launches
    _compare(make_text_subpath(H, causal=causal, frozen=frozen, eps=eps, interpret=True),
             lambda *a: ta.text_subpath(*a, num_heads=H, causal=causal, eps=eps,
                                        frozen=frozen), acts, weights, frozen=frozen)
    assert ta.text_subpath_backward.launches == before


def test_plain_backwards_are_the_functions_gradients():
    """The plain backward functions (what chip_smoke.py holds the kernels
    against) return the Functions' CPU gradients, in argument order."""
    B, T, N, D, H = 1, 3, 4, 16, 2
    acts, weights = _args(31, B, 1 + T * N, D, with_base=True)
    args = _torch_args(acts, weights)
    g = torch.from_numpy(np.random.default_rng(32).standard_normal((B, 1 + T * N, D))
                         .astype(np.float32))
    for fn, plain, inputs in (
            (bb.space_subpath, bb.space_subpath_backward_plain, args),
            (bb.time_subpath, bb.time_subpath_backward_plain, [args[0], *args[2:]])):
        want = bb.vjp(lambda *a: fn(*a, T, H), g, inputs)
        got = plain(g, *inputs, T, H)
        assert len(got) == len(inputs)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    dx, = ta.text_subpath_backward_plain(g, args[0], *args[2:], H, frozen=True)
    assert dx.shape == args[0].shape


def test_training_sub_paths_raise_without_a_kernel():
    """A tensor on neither the CPU nor a CUDA card has no kernel: no fallback."""
    acts, weights = _args(33, 1, 1 + 2 * 2, 16, with_base=True)
    args = [t.detach().to("meta") for t in _torch_args(acts, weights)]
    with pytest.raises(ValueError, match="no kernel"):
        bb.space_subpath(*args, 2, 2)
    with pytest.raises(ValueError, match="no kernel"):
        bb.time_subpath(args[0], *args[2:], 2, 2)
    with pytest.raises(ValueError, match="no kernel"):
        ta.text_subpath(args[0], *args[2:], num_heads=2)
