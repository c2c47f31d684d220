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
    d, n_max = 80, block_kernels.SMEM_OPTIN // (8 * 80) - 1
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
