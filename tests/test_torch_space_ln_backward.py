"""The CPU side of the training backward's LayerNorm gradient and H5's space
backward core: the LayerNorm backward's launch plan (the rows each warp
takes, the partial rows, what the kernel refuses) over every LayerNorm
backward of a B/32, B/16 and H/14 train step; the plain LayerNorm backward
against the JAX package's _ln_bwd and the VJP of its LayerNorm (float32,
atol / rtol 2e-5); the plain backward space core against autograd of the
plain space core and, through the gradients it feeds, against the JAX
package's make_space_subpath_v10 custom VJP with the Pallas kernels in
interpret mode at head dims 64 and 80 (float32, loss sum(sin(f)), gradients
atol 5e-4 / rtol 2e-3, as tests/test_torch_backward.py holds the sub-paths);
which space groups the one-pass kernel takes; and the band chip_smoke.py
holds the card's backward space core to (space_bwd_check), against a
bf16-rounding model of the kernel and a mask fault."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvts_torch.models.configs import tvtsv2_b_16, tvtsv2_b_32, tvtsv2_h_14
from tvts_torch.models.layers import layer_norm_f32
from tvts_torch.ops import block_backward as bb
from tvts_torch.ops import block_kernels as bk

LN_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-4, rtol=2e-3)
SMS = 132  # the H100's SM count
STEPS = {"B/32": (tvtsv2_b_32, 20), "B/16": (tvtsv2_b_16, 20), "H/14": (tvtsv2_h_14, 8)}


def _ln_shapes():
    """(name, M, K) of every LayerNorm backward of one train step: the video
    sub-paths, the text tower's (num_clips captions a clip, 77 tokens) and the
    sort head's (S + num_clips rows a clip); then ragged row counts."""
    out = []
    for arch, (cfg_fn, B) in STEPS.items():
        cfg = cfg_fn()
        v = cfg.vision
        S = 1 + v.num_frames * v.n_keep
        out += [(f"{arch} video", B * S, v.width),
                (f"{arch} text", B * cfg.num_clips * 77, cfg.text.width),
                (f"{arch} sort", B * (S + cfg.num_clips), cfg.sort.embed_dim)]
    return out + [(f"M={M}", M, K) for M, K in ((1, 768), (7, 8), (100, 1000), (2113, 1280),
                                                 (132 * 8 + 1, 512))]


LN_SHAPES = _ln_shapes()


@pytest.mark.parametrize("name, M, K", LN_SHAPES, ids=[s[0] for s in LN_SHAPES])
def test_ln_bwd_plan_covers_every_row_once(name, M, K):
    plan = bb.ln_bwd_plan(M, K, SMS)
    blocks, warps = plan["blocks"], plan["warps"]
    assert warps == blocks * bb.LN_BWD_WARPS
    covered = np.zeros(M, dtype=np.int64)
    counts = []
    for w in range(warps):  # warp w: rows [w * M // W, (w + 1) * M // W)
        lo, hi = w * M // warps, (w + 1) * M // warps
        covered[lo:hi] += 1
        counts.append(hi - lo)
    assert (covered == 1).all()
    assert plan["rows_per_warp"] == (min(counts), max(counts)) and max(counts) - min(counts) <= 1
    for b in range(blocks):  # every block has rows
        assert sum(counts[b * bb.LN_BWD_WARPS:(b + 1) * bb.LN_BWD_WARPS]) > 0
    assert plan["partial_rows"] == blocks <= SMS  # one row of partials a block, a block an SM
    assert plan["chunks"] == -(-K // 256) and plan["colsum_grid"] == (-(-K // 32), 2)
    assert plan["smem"] <= bk.SMEM_OPTIN and plan["threads"] == 256
    # the shapes and the SM count decide, nothing else
    assert bb.ln_bwd_plan(M, K, SMS, pointers={"x": 1 << 20, "dxln": 3 << 20}) == plan


def test_ln_bwd_plan_at_the_b16_step():
    """B/16 at B=20 (M = 23,540 rows of 768): 22 or 23 rows a warp in 132
    blocks, so 132 rows of column partials where the first version wrote
    3,928; 8 rows, one block."""
    plan = bb.ln_bwd_plan(20 * (1 + 12 * 98), 768, SMS)
    assert (plan["rows_per_warp"], plan["blocks"]) == ((22, 23), 132)
    assert bb.ln_bwd_plan(8, 768, SMS)["blocks"] == 1


@pytest.mark.parametrize("M, K, match", [(0, 768, "M = 0"), (100, 12, "K = 12"),
                                         (100, 4, "K = 4"), (100, 770, "K = 770"),
                                         (100, 1288, "K = 1288: .* at most 1280")])
def test_ln_bwd_plan_raises_on_what_the_kernel_does_not_take(M, K, match):
    with pytest.raises(ValueError, match=match):
        bb.ln_bwd_plan(M, K, SMS)


def test_ln_bwd_plan_raises_on_an_unaligned_base():
    with pytest.raises(ValueError, match="dxln at 0x1004 is not 16-byte aligned"):
        bb.ln_bwd_plan(100, 768, SMS, pointers={"x": 0x1000, "dxln": 0x1004})


@pytest.mark.parametrize("with_res", [False, True])
def test_ln_backward_plain_matches_jax_ln_bwd(with_res):
    """dx = res + _ln_bwd(dxln, xhat, rstd, w), and dx, dln_w, dln_b equal the
    VJP of the JAX LayerNorm (_ln_fwd) against dxln, in float32."""
    from tvts_tpu.ops.pallas_block_backward import _ln_bwd, _ln_fwd

    rng = np.random.default_rng(71 + with_res)
    M, K = 37, 48
    x = (rng.standard_normal((M, K)) * 1.5 + 0.3).astype(np.float32)
    w = (1 + 0.2 * rng.standard_normal(K)).astype(np.float32)
    b = (0.1 * rng.standard_normal(K)).astype(np.float32)
    dxln = rng.standard_normal((M, K)).astype(np.float32)
    res = rng.standard_normal((M, K)).astype(np.float32)
    _, xhat, rstd = _ln_fwd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    _, vjp = jax.vjp(lambda *a: _ln_fwd(*a)[0], jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want_dx, want_dw, want_db = (np.asarray(t) for t in vjp(jnp.asarray(dxln)))
    want_ln = np.asarray(_ln_bwd(jnp.asarray(dxln), xhat, rstd, jnp.asarray(w)))
    np.testing.assert_allclose(want_ln, want_dx, **LN_TOL)  # _ln_bwd is the LayerNorm's dx

    xt = torch.from_numpy(x)
    stats = torch.stack([xt.mean(-1), torch.rsqrt(xt.var(-1, unbiased=False) + 1e-5)], -1)
    r = torch.from_numpy(res) if with_res else None
    dx, dw, db = bb.ln_backward(xt, stats, torch.from_numpy(dxln), torch.from_numpy(w), r)
    np.testing.assert_allclose(dx.numpy(), want_dx + (res if with_res else 0), **LN_TOL)
    np.testing.assert_allclose(dw.numpy(), want_dw, **LN_TOL)
    np.testing.assert_allclose(db.numpy(), want_db, **LN_TOL)
    frozen = bb.ln_backward(xt, stats, torch.from_numpy(dxln), torch.from_numpy(w), r,
                            weight_grads=False)
    assert frozen[1] is None and frozen[2] is None and torch.equal(frozen[0], dx)
    assert bb.ln_backward.launches == 0  # the CPU runs no kernel


def _space_inputs(seed, B, T, N, H, d):
    rng = np.random.default_rng(seed)
    S, D = 1 + T * N, H * d
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * D)), dtype=torch.float64)
    dO = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.float64)
    return qkv, dO


def _delta(dO, out, H):
    B, S, D = dO.shape
    return (dO * out).reshape(B, S, H, D // H).sum(-1).transpose(1, 2)


@pytest.mark.parametrize("T, N, H, d", [(1, 4, 2, 8), (3, 5, 2, 16), (12, 3, 3, 8)])
def test_space_core_backward_plain_is_autograd_of_the_plain_core(T, N, H, d):
    qkv, dO = _space_inputs(72 + T, 2, T, N, H, d)
    qkv.requires_grad_()
    out, lse = bk.space_core_plain(qkv, T, H)
    (want,) = torch.autograd.grad(out, qkv, dO.float())
    got = bb.space_core_backward_plain(qkv.detach(), dO, lse.detach(),
                                       _delta(dO.float(), out.detach(), H), T, H)
    assert got.shape == qkv.shape
    torch.testing.assert_close(got, want.float(), rtol=1e-4, atol=1e-5)
    # the CPU path of the wrapper is the plain backward rounded to qkv's dtype
    wrapped = bb.space_core_backward(qkv.detach().float(), dO.float(), lse.detach(),
                                     _delta(dO.float(), out.detach(), H), T, H)
    torch.testing.assert_close(wrapped, got, rtol=1e-5, atol=1e-6)
    assert bb.space_core_backward.launches == bb.space_core_backward.pair_launches == 0


@pytest.mark.parametrize("d", [64, 80])
def test_space_core_backward_grads_match_jax_custom_vjp(d):
    """The space sub-path's gradients that the backward core feeds (dWqkv,
    dbqkv through the plain wgrad; dx, dln_w, dln_b through the plain
    LayerNorm backward), built on the plain backward space core, equal those
    of the JAX custom VJP (interpret mode)."""
    from tvts_tpu.ops.pallas_block_backward import make_space_subpath_v10

    B, T, N, H = 1, 2, 5, 2
    D = H * d
    S, M = 1 + T * N, B * (1 + T * N)
    rng = np.random.default_rng(23 + d)
    x, base = (rng.normal(size=(B, S, D)).astype(np.float32) for _ in range(2))
    ln_s = (1 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    ln_b = (0.1 * rng.normal(size=(D,))).astype(np.float32)
    wqkv = (rng.normal(size=(D, 3 * D)) * D ** -0.5).astype(np.float32)
    bqkv = (rng.normal(size=(3 * D,)) * 0.07).astype(np.float32)
    wproj = (rng.normal(size=(D, D)) * D ** -0.5).astype(np.float32)
    bproj = (rng.normal(size=(D,)) * 0.07).astype(np.float32)
    jax_f = make_space_subpath_v10(T, N, H, fpp=T, interpret=True)
    jargs = [jnp.asarray(a) for a in (x, base, ln_s, ln_b, wqkv, bqkv, wproj, bproj)]
    want = jax.grad(lambda *a: jnp.sum(jnp.sin(jax_f(*a))), argnums=(0, 2, 3, 4, 5))(*jargs)

    xt, w_s, w_b = (torch.from_numpy(a) for a in (x, ln_s, ln_b))
    wq, bq, wp, bpj = (torch.from_numpy(a) for a in (wqkv, bqkv, wproj, bproj))
    qkv = layer_norm_f32(xt, w_s, w_b) @ wq + bq
    attn, lse = bk.space_core_plain(qkv, T, H)
    g = torch.cos(torch.from_numpy(base) + attn @ wp + bpj)  # dL/df of sum(sin(f))
    dattn = g @ wp.T
    dqkv = bb.space_core_backward_plain(qkv, dattn, lse, _delta(dattn, attn, H), T, H)
    xf = xt.reshape(M, D)
    stats = torch.stack([xf.mean(-1), torch.rsqrt(xf.var(-1, unbiased=False) + 1e-5)], -1)
    dwqkv, dbqkv = bb.wgrad(dqkv.reshape(M, 3 * D), xf, stats, (w_s, w_b))
    dx, dln_w, dln_b = bb.ln_backward(xf, stats, dqkv.reshape(M, 3 * D) @ wq.T, w_s)
    for name, got, ref in (("x", dx.reshape(B, S, D), want[0]), ("ln_scale", dln_w, want[1]),
                           ("ln_bias", dln_b, want[2]), ("wqkv", dwqkv.T, want[3]),
                           ("bqkv", dbqkv, want[4])):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL, err_msg=name)


@pytest.mark.parametrize("arch", list(STEPS))
def test_space_core_backward_blocks_fit_at_every_config(arch):
    """The train shapes of every config (and their extraction frames) take the
    one-pass kernel; a group over one block's shared memory takes the pair."""
    v = STEPS[arch][0]().vision
    T, H, d = v.num_frames, v.heads, v.width // v.heads
    for N in (v.n_keep, v.patches_per_frame):
        assert bb.space_bwd_smem(N, d) <= bk.SMEM_OPTIN
        assert bb._check_space_bwd(T, N, H, d)
    # the largest groups one block takes: 384 rows at d = 64, 320 at d = 80
    assert bb._check_space_bwd(1, 383, 12, 64) and not bb._check_space_bwd(1, 384, 12, 64)
    assert bb._check_space_bwd(1, 319, 16, 80) and not bb._check_space_bwd(1, 320, 16, 80)


def test_space_core_backward_smem_at_the_b16_step():
    """L = 99 elements padded to 112 rows of 72 bf16 for q, k, v and dO: 64 KB,
    three blocks an SM; at H/14's L = 77, d = 80, two with room to spare."""
    assert bb.space_bwd_smem(98, 64) == 4 * 112 * 72 * 2 + 2 * 112 * 4
    assert 3 * bb.space_bwd_smem(98, 64) <= 228 * 1024
    assert 2 * bb.space_bwd_smem(76, 80) <= 228 * 1024


@pytest.mark.parametrize("T, N, d, match", [(12, 98, 32, "head dim 32"),
                                            (0, 98, 64, "0 frames"),
                                            (12, 0, 64, "of 0 patches")])
def test_space_core_backward_raises_on_what_it_does_not_take(T, N, d, match):
    with pytest.raises(ValueError, match=match):
        bb._check_space_bwd(T, N, 12, d)


def _rounded_space_backward(qkv, dO, lse, delta, T, H, cls_in_every_frame=False):
    """A model of the one-pass kernel's arithmetic: the plain backward space
    core (block_backward.divided_core_backward_plain) with P and dS rounded to
    bf16 before their products, f32 otherwise. With cls_in_every_frame, the
    CLS query's logit on the CLS key is counted in each of the T frames, not
    in frame 0 only (a mask fault)."""
    B, S, D3 = qkv.shape
    N, d = (S - 1) // T, D3 // 3 // H
    scale = d ** -0.5
    q, k, v = (t.float().reshape(B, S, H, d).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    o = dO.float().reshape(B, S, H, d).transpose(1, 2)
    qp, kp, vp, op = (t[:, :, 1:].reshape(B, H, T, N, d) for t in (q, k, v, o))
    keys = torch.cat([k[:, :, None, :1].expand(B, H, T, 1, d), kp], dim=3)
    vals = torch.cat([v[:, :, None, :1].expand(B, H, T, 1, d), vp], dim=3)
    lse_p, delta_p = (t[:, :, 1:].reshape(B, H, T, N, 1) for t in (lse, delta))
    p = torch.exp(scale * (qp @ keys.transpose(-1, -2)) - lse_p)
    ds = p * (op @ vals.transpose(-1, -2) - delta_p)
    p, ds = p.bfloat16().float(), ds.bfloat16().float()
    dq_p = scale * (ds @ keys)
    dkeys = scale * (ds.transpose(-1, -2) @ qp)
    dvals = p.transpose(-1, -2) @ op
    p0 = torch.exp(scale * (q[:, :, :1] @ k.transpose(-1, -2)) - lse[:, :, :1, None])
    ds0 = p0 * (o[:, :, :1] @ v.transpose(-1, -2) - delta[:, :, :1, None])
    if cls_in_every_frame:
        p0[..., 0] *= T
        ds0[..., 0] *= T
    p0, ds0 = p0.bfloat16().float(), ds0.bfloat16().float()
    dq = torch.cat([scale * (ds0 @ k), dq_p.reshape(B, H, T * N, d)], dim=2)
    dk = scale * (ds0.transpose(-1, -2) @ q[:, :, :1]) + torch.cat(
        [dkeys[:, :, :, :1].sum(2), dkeys[:, :, :, 1:].reshape(B, H, T * N, d)], dim=2)
    dv = p0.transpose(-1, -2) @ o[:, :, :1] + torch.cat(
        [dvals[:, :, :, :1].sum(2), dvals[:, :, :, 1:].reshape(B, H, T * N, d)], dim=2)
    return torch.cat([t.transpose(1, 2).reshape(B, S, H * d) for t in (dq, dk, dv)], dim=-1)


@pytest.mark.parametrize("N, d", [(98, 64), (76, 80)])
def test_space_bwd_check_takes_rounding_and_refuses_a_mask_fault(N, d):
    """chip_smoke.space_bwd_check, the band the card's backward space core is
    held to at the B/16 (N = 98, d = 64) and H/14 (N = 76, d = 80) train
    groups: it takes the bf16-rounding model of the kernel, bf16-stored (half
    of the band at most), and twice the model's arithmetic error; it refuses
    the same model with the CLS query's logit on the CLS key counted in every
    frame, and the plain backward with one CLS dk value off by 2% of its
    group's largest."""
    from chip_smoke import space_bwd_check

    T, H, B = 12, 2, 2
    rng = np.random.default_rng(55)
    S, D = 1 + T * N, H * d
    qkv = torch.tensor(rng.standard_normal((B, S, 3 * D)), dtype=torch.bfloat16)
    dO = torch.tensor(rng.standard_normal((B, S, D)), dtype=torch.bfloat16)
    out, lse = bk.space_core_plain(qkv, T, H)
    delta = _delta(dO.float(), out, H).contiguous()
    want = bb.space_core_backward_plain(qkv, dO, lse, delta, T, H)
    model = _rounded_space_backward(qkv, dO, lse, delta, T, H)
    space_bwd_check(model.bfloat16(), want, T, H)
    space_bwd_check(want + 2 * (model - want), want, T, H)
    with pytest.raises(AssertionError, match="disagrees"):
        space_bwd_check(_rounded_space_backward(qkv, dO, lse, delta, T, H, True).bfloat16(),
                        want, T, H)
    off = want.clone()
    cls_dk = off[:, 0, D:2 * D]
    cls_dk[0, 0] += 0.02 * cls_dk[0, :d].abs().max()
    with pytest.raises(AssertionError, match="disagrees"):
        space_bwd_check(off, want, T, H)
