"""The H7 attention cores of the port on the CPU: their plain versions
(text_core_plain, text_core_backward_plain: the kernels' rounding points),
run inside the text sub-path, against the JAX package's
fused_text_attention_block and the make_text_subpath custom VJP with the
Pallas kernels in interpret mode (float32, d = 64, causal S = 77 and
non-causal ragged S = 131; forward and gradients within atol 2e-5 / rtol
2e-5 of JAX: summation order only); the plain backward against autograd of
the plain forward; and the kernels' launch plan (text_core_plan): every
(query, key) pair once, the tiles above the diagonal skipped when causal,
and what it refuses before any launch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvts_torch.models.layers import layer_norm_f32, linear
from tvts_torch.ops import text_attention as ta

TOL = dict(atol=2e-5, rtol=2e-5)
CASES = [(77, True, 1e-5), (131, False, 1e-6)]  # (S, causal, LN eps)
H, D = 2, 128  # head dim 64


def _arrays(seed, B, S):
    """The JAX package's arguments ([in, out] matrices) from a numpy seed."""
    rng = np.random.default_rng(seed)

    def a(*shape, std=1.0, base=0.0):
        return (base + std * rng.standard_normal(shape)).astype(np.float32)

    return [a(B, S, D), a(D, std=0.1, base=1.0), a(D, std=0.1), a(D, 3 * D, std=0.1),
            a(3 * D, std=0.1), a(D, D, std=0.1), a(D, std=0.1)]


class _PlainCore(torch.autograd.Function):
    """text_core_plain, differentiated by text_core_backward_plain."""

    @staticmethod
    def forward(ctx, qkv, causal):
        out, lse = ta.text_core_plain(qkv, H, causal)
        ctx.save_for_backward(qkv, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        return ta.text_core_backward_plain(qkv, out, lse, g, H, ctx.causal), None


def _subpath(x, ln_w, ln_b, wqkv, bqkv, wproj, bproj, causal, eps):
    """x + Proj(core(LN(x) Wqkv)) with the plain core (weights [out, in])."""
    qkv = linear(layer_norm_f32(x, ln_w, ln_b, eps), wqkv, bqkv)
    return x + linear(_PlainCore.apply(qkv, causal), wproj, bproj)


def _torch_args(arrays):
    return [torch.from_numpy(np.ascontiguousarray(v.T if i in (3, 5) else v))
            for i, v in enumerate(arrays)]


@pytest.mark.parametrize("S, causal, eps", CASES)
def test_plain_core_in_the_subpath_matches_pallas_forward(S, causal, eps):
    from tvts_tpu.ops.pallas_text_attention import fused_text_attention_block as pallas

    arrays = _arrays(3 + causal, 2, S)
    want = pallas(*map(jnp.asarray, arrays), num_heads=H, causal=causal, eps=eps, interpret=True)
    with torch.no_grad():
        got = _subpath(*_torch_args(arrays), causal, eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the public entry runs the plain version on a CPU tensor, and counts nothing
    qkv = torch.randn(2, S, 3 * D, generator=torch.Generator().manual_seed(0))
    before = ta.text_core.launches, ta.text_core_backward.launches
    out, lse = ta.text_core(qkv, H, causal, with_lse=True)
    want_out, want_lse = ta.text_core_plain(qkv, H, causal)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    ta.text_core_backward(qkv, out, lse, torch.ones_like(out), H, causal)
    assert (ta.text_core.launches, ta.text_core_backward.launches) == before
    with pytest.raises(ValueError, match="no kernel"):
        ta.text_core(qkv.to("meta"), H, causal)


@pytest.mark.parametrize("S, causal, eps", CASES)
def test_plain_core_backward_matches_the_jax_subpath_vjp(S, causal, eps):
    from tvts_tpu.ops.pallas_text_attention import make_text_subpath

    arrays = _arrays(5 + causal, 2, S)
    f = make_text_subpath(H, causal=causal, eps=eps, interpret=True)
    jargs = list(map(jnp.asarray, arrays))
    grads = jax.grad(lambda *a: jnp.sum(jnp.sin(f(*a))), argnums=tuple(range(7)))(*jargs)
    targs = [t.requires_grad_() for t in _torch_args(arrays)]
    torch.sin(_subpath(*targs, causal, eps)).sum().backward()
    for i, (t, g) in enumerate(zip(targs, grads)):
        got = t.grad.numpy().T if i in (3, 5) else t.grad.numpy()
        np.testing.assert_allclose(got, np.asarray(g), **TOL, err_msg=f"argument {i}")


@pytest.mark.parametrize("S, causal", [(77, True), (131, False), (131, True), (5, True)])
def test_plain_core_backward_is_the_gradient_of_the_plain_core(S, causal):
    """In float64 (where the kernels' bf16 rounding points are identities):
    dqkv of text_core_backward_plain equals autograd through text_core_plain."""
    gen = torch.Generator().manual_seed(S)
    qkv = torch.randn(2, S, 3 * D, generator=gen, dtype=torch.float64).requires_grad_()
    dO = torch.randn(2, S, D, generator=gen, dtype=torch.float64)
    out, lse = ta.text_core_plain(qkv, H, causal)
    (want,) = torch.autograd.grad(out, qkv, dO)
    got = ta.text_core_backward_plain(qkv.detach(), out.detach(), lse.detach(), dO, H, causal)
    # the plain versions compute in float32
    torch.testing.assert_close(got.double(), want, atol=2e-5, rtol=2e-5)


def _coverage(S, tiles):
    """[S, S] count of (row, column) pairs the tiles compute."""
    count = np.zeros((S, S), np.int64)
    for (r0, r1), cols in tiles:
        for c0, c1 in cols:
            count[r0:r1, c0:c1] += 1
    return count


PLAN_CASES = [(S, causal) for S in (1, 5, 77, 128, 129, 131, 917, 1181)
              for causal in (False, True)]


@pytest.mark.parametrize("S, causal", PLAN_CASES, ids=[f"S{s}-{'causal' if c else 'full'}"
                                                       for s, c in PLAN_CASES])
def test_text_core_plan_covers_every_pair_once(S, causal):
    plan = ta.text_core_plan(3, S, 8, 64, causal)
    assert plan["kernel"] == ("small" if S <= ta.TEXT_SMALL_MAX else "tma")
    q, k = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    needed = (k <= q) if causal else np.ones((S, S), bool)
    for name in ("fwd", "dq", "dkv"):
        count = _coverage(S, plan[name])
        if name == "dkv":  # rows are keys, columns queries
            count = count.T
        assert (count[needed] == 1).all(), name
        assert count.max() <= 1, name
        if causal:  # no tile lies wholly above the diagonal
            for (r0, r1), cols in plan[name]:
                for c0, c1 in cols:
                    assert (c0 <= r1 - 1) if name != "dkv" else (r0 <= c1 - 1), (name, r0, c0)
    if plan["kernel"] == "tma":
        rows_f, rows_b = ta.TEXT_FWD_TILES[0], ta.TEXT_BWD_TILES[0]
        assert plan["fwd_grid"] == (-(-S // rows_f), 8, 3)
        assert plan["bwd_grid"] == (-(-S // rows_b), 8, 3)
        assert plan["scratch_rows"] % 64 == 0 and S <= plan["scratch_rows"] < S + 64
        assert max(plan["bwd_smem"]) <= 227 * 1024 and plan["fwd_smem"] <= 227 * 1024
    else:
        assert plan["fwd_grid"] == plan["bwd_grid"] == (8, 3)
        assert plan["threads"] == 32 * -(-S // 16) and plan["scratch_rows"] == 0


def test_text_core_plan_refuses_before_any_launch():
    with pytest.raises(ValueError, match="head dim 80"):
        ta.text_core_plan(2, 77, 16, 80, True)
    with pytest.raises(ValueError, match="at least one"):
        ta.text_core_plan(0, 77, 8, 64, True)
    with pytest.raises(ValueError, match="not 16-byte aligned"):
        ta.text_core_plan(2, 1181, 8, 64, False, pointers={"qkv": 1 << 20, "out": (1 << 20) + 8})
    plan = ta.text_core_plan(2, 1181, 8, 64, False, pointers={"qkv": 1 << 20, "lse": None})
    assert plan is ta.text_core_plan(2, 1181, 8, 64, False)  # the shapes decide, nothing else
