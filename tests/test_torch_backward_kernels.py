"""The CPU side of the training backward's two Hopper kernels: wgrad's launch
plan (the row splits and what the kernel refuses) over every weight-gradient
product of a B/32, B/16 and H/14 train step, the plain weight gradient, and
the plain backward time core, against autograd of the plain time core and,
through the weight gradients it feeds, against the JAX package's
make_time_subpath custom VJP with the Pallas kernels in interpret mode
(float32, loss sum(sin(f)), gradients atol 5e-4 / rtol 2e-3, as
tests/test_torch_backward.py holds the sub-paths)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import wgrad_products
from tvts_torch.models.configs import tvtsv2_b_16, tvtsv2_b_32, tvtsv2_h_14
from tvts_torch.models.layers import layer_norm_f32
from tvts_torch.ops import block_backward as bb
from tvts_torch.ops import block_kernels as bk

GRAD_TOL = dict(atol=5e-4, rtol=2e-3)
SMS = 132  # the H100's SM count
# every weight-gradient product of one train step: (arch, B) -> products
STEPS = {"B/32": (tvtsv2_b_32, 20), "B/16": (tvtsv2_b_16, 20), "H/14": (tvtsv2_h_14, 8)}
PRODUCTS = [(arch, p) for arch, (cfg, B) in STEPS.items() for p in wgrad_products(cfg(), B)]


@pytest.mark.parametrize("arch, p", PRODUCTS, ids=[f"{a}-{p['name']}" for a, p in PRODUCTS])
def test_wgrad_plan_splits_cover_every_row_once(arch, p):
    M, N1, N2, ln = p["M"], p["N1"], p["N2"], p["ln"] is not None
    plan = bb.wgrad_plan(M, N1, N2, N1, N2, SMS, ln)
    splits, rows = plan["splits"], plan["rows_per_split"]
    assert rows % 64 == 0 and plan["k_steps"] == rows // 64  # whole 64-row stages a split
    covered = np.zeros(M, dtype=np.int64)
    for z in range(splits):
        lo, hi = z * rows, min(M, (z + 1) * rows)
        assert lo < hi  # no empty split
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # 128 x 256 tiles (256 x 128 with the LayerNorm, whose operand takes the 128 side)
    grid = (-(-N1 // 256), -(-N2 // 128)) if ln else (-(-N2 // 256), -(-N1 // 128))
    assert plan["grid"] == (*grid, splits)
    assert plan["colsum_parts"] == splits * (grid[1] if ln else grid[0])
    assert plan["smem"] <= bk.SMEM_OPTIN and plan["threads"] == (384 if ln else 288)
    # the shapes and the SM count decide, nothing else: strides and addresses do not
    again = bb.wgrad_plan(M, N1, N2, 3 * N1, 2 * N2, SMS, ln,
                          pointers={"a": 1 << 20, "b": 3 << 20})
    assert again == plan


def test_wgrad_plan_at_the_b16_step():
    """The splits the kernel's header states for B/16 at B=20 (M = 23,540)."""
    M = 20 * (1 + 12 * 98)
    assert bb.wgrad_plan(M, 2304, 768, 2304, 768, SMS, True)["splits"] == 2  # dWqkv, 54 tiles
    assert bb.wgrad_plan(M, 768, 768, 768, 768, SMS)["splits"] == 7  # dWproj, 18 tiles
    assert bb.wgrad_plan(M, 3072, 768, 3072, 768, SMS, True)["splits"] == 3  # dWfc, 72 tiles
    assert bb.wgrad_plan(M, 768, 3072, 768, 3072, SMS)["splits"] == 3
    one = bb.wgrad_plan(40, 768, 768, 768, 768, SMS)  # M below one split
    assert (one["splits"], one["rows_per_split"]) == (1, 64)


@pytest.mark.parametrize("args, match", [
    ((0, 768, 768, 768, 768), "M = 0"),
    ((100, 12, 768, 12, 768), "N1 = 12"),
    ((100, 768, 100, 768, 100), "N2 = 100"),
    ((100, 768, 768, 772, 768), "lda = 772"),
    ((100, 768, 768, 768, 516), "ldb = 516"),
    ((100, 768, 768, 512, 768), "lda = 512 is shorter"),
])
def test_wgrad_plan_raises_on_what_the_kernel_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        bb.wgrad_plan(*args, SMS)


def test_wgrad_plan_raises_on_an_unaligned_base():
    with pytest.raises(ValueError, match="b at 0x1008 is not 16-byte aligned"):
        bb.wgrad_plan(100, 768, 768, 768, 768, SMS, pointers={"a": 0x1000, "b": 0x1008})


@pytest.mark.parametrize("with_ln", [False, True])
def test_wgrad_plain_is_the_weight_gradient(with_ln):
    """On the CPU `wgrad` is wgrad_plain: a^T LN?(b) and colsum(a), LN(b) from
    the row statistics rounded to b's dtype as the kernel rounds it."""
    rng = np.random.default_rng(61)
    M, N1, N2 = 50, 24, 16
    a = torch.tensor(rng.standard_normal((M, N1)), dtype=torch.bfloat16)
    x = torch.tensor(rng.standard_normal((M, N2)) + 0.5, dtype=torch.bfloat16)
    w, b = (torch.tensor(rng.standard_normal(N2), dtype=torch.float32) for _ in range(2))
    xf = x.float()
    mean, var = xf.mean(-1), xf.var(-1, unbiased=False)
    stats = torch.stack([mean, torch.rsqrt(var + 1e-5)], -1)
    dw, db = bb.wgrad(a, x, stats if with_ln else None, (w, b) if with_ln else None,
                      dtype=torch.float32)
    want_b = layer_norm_f32(x, w, b) if with_ln else x
    torch.testing.assert_close(dw, a.float().t() @ want_b.float(), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(db, a.float().sum(0), rtol=1e-6, atol=1e-5)
    assert bb.wgrad.launches == 0  # the CPU runs no kernel


def _time_inputs(seed, B, T, N, H, d):
    rng = np.random.default_rng(seed)
    S, D = 1 + T * N, H * d
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * D)), dtype=torch.float64)
    dO = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.float64)
    return qkv, dO


def _delta(dO, out, H):
    B, S, D = dO.shape
    return (dO * out).reshape(B, S, H, D // H).sum(-1).transpose(1, 2)


@pytest.mark.parametrize("T, N, H, d", [(1, 4, 2, 8), (3, 5, 2, 16), (12, 3, 3, 8)])
def test_time_core_backward_plain_is_autograd_of_the_plain_core(T, N, H, d):
    qkv, dO = _time_inputs(62 + T, 2, T, N, H, d)
    qkv.requires_grad_()
    out, lse = bb.time_core_plain(qkv, T, H)
    (want,) = torch.autograd.grad(out, qkv, dO.float())
    got = bb.time_core_backward_plain(qkv.detach(), dO, lse.detach(),
                                      _delta(dO.float(), out.detach(), H), T, H)
    assert got.shape == qkv.shape
    torch.testing.assert_close(got, want.float(), rtol=1e-4, atol=1e-5)
    # the CPU path of the wrapper is the plain backward rounded to qkv's dtype
    wrapped = bb.time_core_backward(qkv.detach().float(), dO.float(), lse.detach(),
                                    _delta(dO.float(), out.detach(), H), T, H)
    torch.testing.assert_close(wrapped, got, rtol=1e-5, atol=1e-6)
    assert bb.time_core_backward.launches == 0


def test_time_core_plain_is_the_time_attention():
    """time_core_plain's rows are the eager tower's time attention."""
    from tvts_torch.ops.attention import divided_space_time_attention, split_heads

    T, N, H, d = 3, 5, 2, 16
    qkv, _ = _time_inputs(70, 2, T, N, H, d)
    qkv = qkv.float()
    out, _ = bb.time_core_plain(qkv, T, H)
    q, k, v = qkv.chunk(3, dim=-1)
    want = divided_space_time_attention(split_heads(q * d ** -0.5, H), split_heads(k, H),
                                        split_heads(v, H), T, N, "time")
    torch.testing.assert_close(out, want.transpose(1, 2).reshape(out.shape), rtol=1e-5,
                               atol=1e-5)


def test_time_core_backward_dw_halves_match_jax_custom_vjp():
    """The sub-path's weight gradients built on the plain backward time core
    and the plain wgrad equal those of the JAX custom VJP (interpret mode)."""
    from tvts_tpu.ops.pallas_block_backward import make_time_subpath

    B, T, N, D, H = 2, 3, 5, 32, 4
    S, M, d = 1 + T * N, B * (1 + T * N), D // H
    rng = np.random.default_rng(21)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    ln_s, ln_b = (rng.normal(size=(D,)).astype(np.float32) for _ in range(2))
    wqkv = (rng.normal(size=(D, 3 * D)) * 0.07).astype(np.float32)
    bqkv = (rng.normal(size=(3 * D,)) * 0.07).astype(np.float32)
    wproj = (rng.normal(size=(D, D)) * 0.07).astype(np.float32)
    bproj = (rng.normal(size=(D,)) * 0.07).astype(np.float32)
    jax_f = make_time_subpath(T, N, H, chunk=4, save_probs=True, interpret=True)
    jargs = [jnp.asarray(a) for a in (x, ln_s, ln_b, wqkv, bqkv, wproj, bproj)]
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_f(*a))), argnums=(3, 4, 5, 6))(*jargs)

    xt, w_s, w_b = (torch.from_numpy(a) for a in (x, ln_s, ln_b))
    wq, bq, wp, bpj = (torch.from_numpy(a) for a in (wqkv, bqkv, wproj, bproj))
    qkv = layer_norm_f32(xt, w_s, w_b) @ wq + bq
    attn, lse = bb.time_core_plain(qkv, T, H)
    g = torch.cos(xt + attn @ wp + bpj)  # dL/df of sum(sin(f))
    dattn = g @ wp.T
    dqkv = bb.time_core_backward_plain(qkv, dattn, lse, _delta(dattn, attn, H), T, H)
    xf = xt.reshape(M, D)
    stats = torch.stack([xf.mean(-1), torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5)], -1)
    dwqkv, dbqkv = bb.wgrad(dqkv.reshape(M, 3 * D), xf, stats, (w_s, w_b))
    dwproj, dbproj = bb.wgrad(g.reshape(M, D), attn.reshape(M, D))
    assert d * H == D
    for name, got, ref in (("wqkv", dwqkv.T, want[0]), ("bqkv", dbqkv, want[1]),
                           ("wproj", dwproj.T, want[2]), ("bproj", dbproj, want[3])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("arch", list(STEPS))
def test_time_core_backward_blocks_fit_at_every_config(arch):
    cfg = STEPS[arch][0]()
    v = cfg.vision
    T, H, d = v.num_frames, v.heads, v.width // v.heads
    heads = bb.time_bwd_heads(T, H)
    assert heads * (T + 1) <= bb.TIME_BWD_THREADS
    assert bb.time_bwd_smem(T, heads, d) <= bk.SMEM_OPTIN
    bb._check_time_bwd(T, H, d)
    for t in (1, 32):  # every frame count the kernel takes fits too
        bb._check_time_bwd(t, 16, 80)


@pytest.mark.parametrize("T, d, match", [(33, 64, "33 frames"), (0, 64, "0 frames"),
                                         (12, 32, "head dim 32")])
def test_time_core_backward_raises_on_what_it_does_not_take(T, d, match):
    with pytest.raises(ValueError, match=match):
        bb._check_time_bwd(T, 12, d)
