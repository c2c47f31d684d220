"""H9 (the attention cores on their own) and the extraction forward at every
kernel_version, on the CPU against the JAX package with its Pallas kernels in
interpret mode (f32 inputs; H9 also at the head dims 64 and 80 within
2e-5). The port has one kernel set for every geometry, so the JAX
package's kernel_version 2, 6, 7 and 8 (row-major, one call per block,
d-major, d-major with space and MLP fused) all compare with the one H1 -> H2 ->
H3 chain and its H4 tail. float32, atol 3e-5 / rtol 1e-4
(tests/test_fused_forward.py); seeded noise on every parameter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from chip_smoke import CORE_SHAPES, F32_BAND, core_inputs, f32_controls
from tests.test_torch_vit import jax_params, port_model, tiny_inputs, tiny_vision
from tvts_torch.ops.attention import divided_space_time_attention
from tvts_torch.ops.attention_cores import divided_space_time_attention_fused
from tvts_torch.ops.fused_forward import space_time_vit_fused_forward

TOL = dict(atol=3e-5, rtol=1e-4)


def _qkv(seed, B, H, S, d):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, H, S, d)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("mode", ["space", "time"])
def test_attention_cores_match_jax_pallas_cores(mode):
    from tvts_tpu.ops.pallas_attention import divided_space_time_attention_fused as jax_fused

    B, H, T, N, d = 2, 3, 4, 5, 8
    q, k, v = _qkv(0, B, H, 1 + T * N, d)
    want = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), T, N, mode, interpret=True)
    before = divided_space_time_attention_fused.launches
    got = divided_space_time_attention_fused(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v), T, N, mode)
    assert divided_space_time_attention_fused.launches == before  # the CPU runs the plain version
    assert got.shape == (B, H, 1 + T * N, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["space", "time"])
@pytest.mark.parametrize("d", [64, 80])
def test_attention_cores_f32_match_jax_at_the_tower_head_dims(mode, d):
    """H9 in f32 (the dtype of an f32 use_pallas tower) at the head dims the
    kernels take: the plain path the CPU runs within 2e-5 of the JAX function
    with its Pallas kernels interpreted in f32."""
    from tvts_tpu.ops.pallas_attention import divided_space_time_attention_fused as jax_fused

    B, H, T, N = 1, 2, 3, 16
    q, k, v = _qkv(5 + d, B, H, 1 + T * N, d)
    q *= d ** -0.5
    want = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), T, N, mode, interpret=True)
    got = divided_space_time_attention_fused(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v), T, N, mode)
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("mode", ["space", "time"])
@pytest.mark.parametrize("label", list(CORE_SHAPES))
def test_f32_band_tells_f32_from_tf32_and_bf16_staging(label, mode):
    """chip_smoke's F32_BAND, which holds H9 in f32 on the card, at each core
    shape (one clip): plain f32 lies well inside it from an f64 reference, and
    plain on what a TF32 mma or a bf16-staged kernel reads lies outside it by
    more than twice."""
    _, T, N, H, d = CORE_SHAPES[label]
    qkv = core_inputs(1, T, N, H, d, 3, "cpu", dtype=torch.float32)
    ref = divided_space_time_attention(*(t.double() for t in qkv), T, N, mode)
    tol = F32_BAND * ref.abs().max().item()
    got = divided_space_time_attention(*qkv, T, N, mode)
    assert (got.double() - ref).abs().max().item() <= tol / 10
    controls = f32_controls(qkv, T, N, mode)
    assert min(controls.values()) > 2 * tol, (controls, tol)


# The f32 kernels' arithmetic (csrc/attention.cuh), modelled in plain torch.
# Space: q takes the log2 logit scale, then every product is 3xTF32 on the
# tensor cores: operands (the probabilities too) split into hi = x truncated
# to TF32 and the remainder x - hi, which the mma reads truncated to TF32
# too; the three products lo hi, hi lo, hi hi added in that order (a product
# of two TF32 values is exact in f32, so f32 matmuls of the parts model the
# mma). Keys run in 32-key tiles with an online softmax in the log2 domain
# rescaled once a tile; where a frame's 16-row slabs leave one over after
# whole rounds of the block's warps (4, or 8 where two blocks do not fit an
# SM), that slab's 8-key chunks are split over the warps and their partials
# merged. Time: f32 FMA, the 1 + T logits, their max, then p and P V. The
# CLS row is the split-KV kernel's, plain f32 in both.
SPF_BK = 32
LOG2E = 1.4426950408889634


def trunc_tf32(t):
    """f32 t truncated to TF32 (10 mantissa bits): what a TF32 mma reads of
    raw f32 bits."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tf32_parts(x, single):
    hi = trunc_tf32(x)
    return hi, None if single else trunc_tf32(x - hi)


def _mma_3xtf32(acc, a, b, single=False):
    """acc + a @ b as the kernel's mma.sync steps sum it; `single`: one TF32
    product of the high parts (the design the band refuses)."""
    (ah, al), (bh, bl) = _tf32_parts(a, single), _tf32_parts(b, single)
    if not single:
        acc = acc + al @ bh
        acc = acc + ah @ bl
    return acc + ah @ bh


def _space_partial(q, k, v, k_lo, k_hi, single):
    """(m, l, o) of the rows q (scaled to log2 units) over keys [k_lo, k_hi)."""
    m = torch.full((*q.shape[:-1], 1), -torch.inf)
    l, o = torch.zeros_like(m), torch.zeros_like(q)
    for k0 in range(k_lo, k_hi, SPF_BK):
        k1 = min(k0 + SPF_BK, k_hi)
        s = _mma_3xtf32(0, q, k[..., k0:k1, :].transpose(-1, -2), single)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp2(m - m_new), torch.exp2(s - m_new)
        l, m = l * corr + p.sum(-1, keepdim=True), m_new
        o = _mma_3xtf32(o * corr, p, v[..., k0:k1, :], single)
    return m, l, o


def _space_rows(q, k, v, N, d, single):
    """The patch rows of every frame: q [..., N, d] over k, v [..., 1 + N, d]."""
    from tvts_torch.ops.attention_cores import space_core_f32_smem

    q = q * LOG2E
    n_slabs, chunks = -(-N // 16), -(-(N + 1) // 8)
    warps = 4 if 2 * (space_core_f32_smem(N, d) + 1024) <= 228 * 1024 else 8
    split = n_slabs > warps and n_slabs % warps == 1
    whole = min(N, (n_slabs - split) * 16)
    m, l, o = _space_partial(q[..., :whole, :], k, v, 0, N + 1, single)
    out = [o / l]
    if split:
        parts = [_space_partial(q[..., whole:, :], k, v, w * chunks // warps * 8,
                                min((w + 1) * chunks // warps * 8, N + 1), single)
                 for w in range(warps)]
        m = torch.stack([p[0] for p in parts]).amax(0)
        l = sum(p[1] * torch.exp2(p[0] - m) for p in parts)
        out.append(sum(p[2] * torch.exp2(p[0] - m) for p in parts) / l)
    return torch.cat(out, -2)


def _frames(t, T, N, mode):
    """Patch rows [B, H, groups, rows, d] and each group's keys with the CLS
    key first: space groups are frames, time groups locations."""
    B, H, _, d = t.shape
    g = t[:, :, 1:].reshape(B, H, T, N, d)
    if mode == "time":
        g = g.transpose(2, 3)
    return g, torch.cat([t[:, :, None, :1].expand(*g.shape[:3], 1, d), g], 3)


def core_kernel_model(q, k, v, T, N, mode, single=False):
    """H9 on f32 q (pre-scaled), k, v [B, H, S, d] as the f32 kernels compute it."""
    B, H, S, d = q.shape
    qg, _ = _frames(q, T, N, mode)
    _, kg = _frames(k, T, N, mode)
    _, vg = _frames(v, T, N, mode)
    if mode == "time":
        logits = qg @ kg.transpose(-1, -2)
        p = torch.exp(logits - logits.amax(-1, keepdim=True))
        out = ((p @ vg) / p.sum(-1, keepdim=True)).transpose(2, 3)
    else:
        out = _space_rows(qg, kg, vg, N, d, single)
    cls = divided_space_time_attention(q, k, v, T, N, mode)[:, :, :1]
    return torch.cat([cls, out.reshape(B, H, T * N, d)], 2)


@pytest.mark.parametrize("mode", ["space", "time"])
@pytest.mark.parametrize("label", list(CORE_SHAPES))
def test_f32_core_design_holds_the_f32_band(label, mode):
    """The f32 kernels' arithmetic lies within F32_BAND * max|ref| of plain
    f32 (and of f64) at each core shape (one clip); the space core with one
    TF32 product a step instead of three, and plain on what a TF32 mma reads,
    lie outside it."""
    _, T, N, H, d = CORE_SHAPES[label]
    qkv = core_inputs(1, T, N, H, d, 3, "cpu", dtype=torch.float32)
    want = divided_space_time_attention(*qkv, T, N, mode)
    want64 = divided_space_time_attention(*(t.double() for t in qkv), T, N, mode)
    tol = F32_BAND * want.abs().max().item()
    got = core_kernel_model(*qkv, T, N, mode)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert (got - want).abs().max().item() <= tol / 4
    assert (got.double() - want64).abs().max().item() <= tol / 4
    assert f32_controls(qkv, T, N, mode)["TF32 q, k, v"] > tol
    if mode == "space":
        single = core_kernel_model(*qkv, T, N, mode, single=True)
        assert (single - want).abs().max().item() > tol


@pytest.mark.parametrize("mode", ["space", "time"])
@pytest.mark.parametrize("d", [64, 80])
def test_f32_core_design_matches_jax_at_the_tower_head_dims(mode, d):
    """The f32 kernels' arithmetic within 2e-5 of the JAX H9 with its Pallas
    kernels interpreted in f32, at the head dims the kernels take; the space
    frame spans three key tiles, so the once-a-tile rescale runs, and its
    five 16-row slabs leave one over after a round of four warps, so the
    split slab's merge runs too."""
    from tvts_tpu.ops.pallas_attention import divided_space_time_attention_fused as jax_fused

    B, H, T, N = 1, 2, 3, 70
    q, k, v = _qkv(9 + d, B, H, 1 + T * N, d)
    q *= d ** -0.5
    want = jax_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), T, N, mode, interpret=True)
    got = core_kernel_model(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), T, N,
                            mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


@pytest.mark.parametrize("d", [64, 80])
def test_space_core_f32_frame_rule(d):
    """The f32 space core stages the frame's keys and values padded to 8 rows
    and d + 4 columns: space_core_f32_max_patches is the largest N that fits
    the block, H/14's frame (N = 256, d = 80) fits, and one more patch than
    the limit is refused before the library loads."""
    from tvts_torch.ops import attention_cores, block_kernels

    n_max = attention_cores.space_core_f32_max_patches(d)
    assert attention_cores.space_core_f32_smem(n_max, d) <= block_kernels.SMEM_OPTIN
    assert attention_cores.space_core_f32_smem(n_max + 1, d) > block_kernels.SMEM_OPTIN
    assert attention_cores.space_core_f32_smem(196, 64) == 2 * 200 * 68 * 4
    assert attention_cores.space_core_f32_smem(256, 80) <= block_kernels.SMEM_OPTIN
    attention_cores._check_space_frame_f32(n_max, d)
    with pytest.raises(ValueError, match=f"at most {n_max} patches"):
        attention_cores._check_space_frame_f32(n_max + 1, d)


def test_attention_core_f32_launch_failure_raises(monkeypatch):
    """On the kernel path a launch the library refuses raises: nothing falls
    back to the plain version (the library and the card are stood in for)."""
    import contextlib

    from tvts_torch.ops import block_kernels

    class Library:
        calls = []

        def tvts_attention_core_strided(self, *args):
            self.calls.append(args)
            return 1  # cudaErrorInvalidValue

        def tvts_error_string(self, err):
            return b"invalid argument"

    lib = Library()
    monkeypatch.setattr(block_kernels, "_dispatch", lambda t: True)
    monkeypatch.setattr(block_kernels, "library", lambda: lib)
    monkeypatch.setattr(block_kernels, "_stream", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, 1, 2, 1 + 2 * 3, 64))
    for mode in ("space", "time"):
        before = (divided_space_time_attention_fused.launches,
                  divided_space_time_attention_fused.f32_time_launches)
        with torch.no_grad(), pytest.raises(RuntimeError, match="invalid argument"):
            divided_space_time_attention_fused(q, k, v, 2, 3, mode)
        assert lib.calls[-1][-3:-1] == (int(mode == "space"), 1)  # space flag, f32
        assert (divided_space_time_attention_fused.launches,
                divided_space_time_attention_fused.f32_time_launches) == before


def test_attention_cores_take_f32_and_refuse_mixed_dtypes(monkeypatch):
    """q, k and v all bf16 or all f32; mixed dtypes (or another dtype) raise
    before any dispatch. With the kernel dispatch forced (no card needed),
    an f32 frame that does not fit a space-core block raises ValueError,
    never the plain version."""
    from tvts_torch.ops import attention_cores, block_kernels

    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 1, 2, 1 + 2 * 3, 8))
    for args in ((q, k.bfloat16(), v), (q.bfloat16(), k.bfloat16(), v),
                 (q.double(), k.double(), v.double())):
        with pytest.raises(TypeError, match="all bf16 or all f32"):
            divided_space_time_attention_fused(*args, 2, 3, "space")
    out = divided_space_time_attention_fused(q, k, v, 2, 3, "space")
    assert out.dtype == torch.float32
    assert divided_space_time_attention_fused(q.bfloat16(), k.bfloat16(), v.bfloat16(), 2, 3,
                                              "space").dtype == torch.bfloat16
    d, n_max = 80, block_kernels.SMEM_OPTIN // (8 * (80 + 4)) // 8 * 8 - 1
    assert attention_cores.space_core_f32_smem(n_max, d) <= block_kernels.SMEM_OPTIN
    assert attention_cores.space_core_f32_smem(n_max + 1, d) > block_kernels.SMEM_OPTIN
    assert attention_cores.space_core_f32_smem(256, 80) <= block_kernels.SMEM_OPTIN  # H/14
    monkeypatch.setattr(block_kernels, "_dispatch", lambda t: True)
    big = tuple(torch.zeros(1, 1, 1 + (n_max + 1), d) for _ in range(3))
    with torch.no_grad(), pytest.raises(ValueError, match=f"at most {n_max} patches"):
        divided_space_time_attention_fused(*big, 1, n_max + 1, "space")


def test_attention_cores_check_their_arguments():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 1, 2, 1 + 2 * 3, 8))
    with pytest.raises(ValueError, match="mode"):
        divided_space_time_attention_fused(q, k, v, 2, 3, "joint")
    with pytest.raises(ValueError, match="token count"):
        divided_space_time_attention_fused(q, k, v, 2, 4, "space")
    with pytest.raises(ValueError, match="no kernel"):  # no fallback off the CPU and the card
        divided_space_time_attention_fused(q.to("meta"), k.to("meta"), v.to("meta"), 2, 3, "space")
    torch.testing.assert_close(divided_space_time_attention_fused(q, k, v, 2, 3, "time"),
                               divided_space_time_attention(q, k, v, 2, 3, "time"),
                               rtol=0, atol=0)


def test_attention_cores_refuse_autograd_on_the_kernel_path(monkeypatch):
    """The kernels are forward only and record no graph: where the call would
    launch them (the dispatch is forced here, no card needed) it raises rather
    than drop the gradients of q, k and v; without autograd it goes on to the
    kernels' own checks. On the CPU the plain version stays differentiable."""
    from tvts_torch.ops import block_kernels

    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 1, 2, 1 + 2 * 3, 8))
    q.requires_grad_()
    out = divided_space_time_attention_fused(q, k, v, 2, 3, "space")
    assert out.requires_grad
    monkeypatch.setattr(block_kernels, "_dispatch", lambda t: True)
    with pytest.raises(RuntimeError, match="forward only"):
        divided_space_time_attention_fused(q, k, v, 2, 3, "space")
    with pytest.raises(RuntimeError, match="forward only"):
        divided_space_time_attention_fused(q.detach(), k, v.requires_grad_(), 2, 3, "space")
    with torch.no_grad(), pytest.raises(ValueError, match="head dim"):
        divided_space_time_attention_fused(q, k, v, 2, 3, "space")


@pytest.mark.parametrize("pool", ["openai", "openclip"])
def test_use_pallas_tower_matches_flax_use_pallas_tower(pool):
    """SpaceTimeViT(use_pallas=True): the space core of every block through
    divided_space_time_attention_fused (time stays plain), against the flax
    tower built with use_pallas=True, its kernels interpreted."""
    from tvts_tpu.models.configs import VisionConfig as JaxVisionConfig
    from tvts_tpu.models.space_time_vit import SpaceTimeViT as JaxSpaceTimeViT

    kw = tiny_vision(pool)
    _, params = jax_params(kw)
    video, keep = tiny_inputs(5)
    with pltpu.force_tpu_interpret_mode():
        want_p, want_t = JaxSpaceTimeViT(JaxVisionConfig(**kw), use_pallas=True).apply(
            {"params": params}, jnp.asarray(video), jnp.asarray(keep))
    model = port_model(kw, params)
    model.use_pallas = True
    calls = []
    from tvts_torch.ops import attention_cores

    original = attention_cores.divided_space_time_attention_fused

    def counting(*args):
        calls.append(args[-1])
        return original(*args)

    attention_cores.divided_space_time_attention_fused = counting
    try:
        with torch.no_grad():
            got_p, got_t = model(torch.from_numpy(video), torch.from_numpy(keep))
    finally:
        attention_cores.divided_space_time_attention_fused = original
    assert calls == ["space"] * kw["layers"]
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)


@pytest.mark.parametrize("need_tokens", [True, False])
@pytest.mark.parametrize("pool", ["openai", "openclip"])
@pytest.mark.parametrize("version", [2, 6, 7, 8])
def test_fused_forward_matches_jax_at_every_kernel_version(version, pool, need_tokens):
    from tvts_tpu.models.configs import VisionConfig as JaxVisionConfig
    from tvts_tpu.ops.fused_forward import space_time_vit_fused_forward as jax_fused_forward

    kw = tiny_vision(pool)
    _, params = jax_params(kw)
    video, keep = tiny_inputs(6)
    want_p, want_t = jax_fused_forward(
        params, JaxVisionConfig(**kw), jnp.asarray(video), jnp.asarray(keep), dtype=jnp.float32,
        kernel_version=version, need_tokens=need_tokens, interpret=True)
    with torch.no_grad():
        got_p, got_t = space_time_vit_fused_forward(
            port_model(kw, params), torch.from_numpy(video), torch.from_numpy(keep),
            need_tokens=need_tokens)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    if need_tokens:
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)
    else:
        assert got_t is None and want_t is None


@pytest.mark.parametrize("version", [2, 4, 6, 7, 8])
def test_make_embed_fns_accepts_every_kernel_version(version):
    """The knob is accepted and ignored: every version is the same kernels."""
    from tests.test_torch_train import port_setup
    from tvts_torch.eval.embed import make_embed_fns

    model, batch = port_setup()
    model.eval()
    _, plain = make_embed_fns(model, use_fused=True)
    _, knob = make_embed_fns(model, use_fused=True, kernel_version=version)
    assert torch.equal(plain(batch["video"], batch["keep_ind"].long()),
                       knob(batch["video"], batch["keep_ind"].long()))
