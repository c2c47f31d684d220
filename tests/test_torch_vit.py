"""The eager PyTorch tower (tvts_torch) against the flax reference, in float32
on the CPU. Tolerance atol 3e-5 / rtol 1e-4, as tests/test_fused_forward.py
holds the Pallas path against `apply`. Every parameter carries seeded noise:
at init the time attention is zero (qkv 0, proj 1), which would hide it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tvts_torch.models.configs import VisionConfig
from tvts_torch.models.space_time_vit import SpaceTimeViT
from tvts_torch.utils.convert import state_dict_from_jax

ATOL, RTOL = 3e-5, 1e-4


def tiny_vision(pool: str = "openai", **kw) -> dict:
    """Toy geometry of tests/test_tvtsv2_parity.py: width 64, 2 layers, 4 heads,
    32^2 input (4 patches per frame), 4 frames."""
    return dict(input_resolution=32, patch_size=16, width=64, layers=2, heads=4,
                output_dim=48, num_frames=4, mask_ratio=0.5, pool_style=pool,
                act="quick_gelu" if pool == "openai" else "gelu", **kw)


def tiny_inputs(seed: int, batch: int = 2, frames: int = 4):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(batch, frames, 3, 32, 32)).astype(np.float32)
    keep = np.stack([rng.permutation(4)[:2] for _ in range(batch)]).astype(np.int32)
    return video, keep


def jax_params(kw: dict, seed: int = 0):
    """(flax module, params with 0.02 seeded noise on every leaf)."""
    from tvts_tpu.models.configs import VisionConfig as JaxVisionConfig
    from tvts_tpu.models.space_time_vit import SpaceTimeViT as JaxSpaceTimeViT

    module = JaxSpaceTimeViT(JaxVisionConfig(**kw))
    video, keep = tiny_inputs(0)
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(video),
                         jnp.asarray(keep))["params"]
    noise = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * noise.normal(size=a.shape).astype(np.float32),
        params)
    return module, params


def port_model(kw: dict, params) -> SpaceTimeViT:
    model = SpaceTimeViT(VisionConfig(**kw))
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_dict_from_jax(params).items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("mode", ["space", "time"])
def test_divided_attention_matches_jax(mode):
    from tvts_tpu.ops.attention import divided_space_time_attention as jax_attention

    from tvts_torch.ops.attention import divided_space_time_attention

    B, H, T, N, d = 2, 3, 4, 5, 8
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, H, 1 + T * N, d)).astype(np.float32)
               for _ in range(3))
    want = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), T, N, mode)
    got = divided_space_time_attention(torch.from_numpy(q), torch.from_numpy(k),
                                       torch.from_numpy(v), T, N, mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("pool", ["openai", "openclip"])
@pytest.mark.parametrize("masked", [False, True])
def test_space_time_vit_matches_flax(pool, masked):
    kw = tiny_vision(pool)
    module, params = jax_params(kw)
    video, keep = tiny_inputs(3)
    keep = keep if masked else None
    want_p, want_t = module.apply({"params": params}, jnp.asarray(video),
                                  None if keep is None else jnp.asarray(keep))
    with torch.no_grad():
        got_p, got_t = port_model(kw, params)(
            torch.from_numpy(video), None if keep is None else torch.from_numpy(keep))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL, rtol=RTOL)


def test_tube_masking_matches_jax():
    from tvts_tpu.ops import masking as jax_masking

    from tvts_torch.ops import masking

    got = masking.make_tube_keep_indices(16, 0.5, np.random.default_rng(5), batch=3)
    want = jax_masking.make_tube_keep_indices(16, 0.5, np.random.default_rng(5), batch=3)
    np.testing.assert_array_equal(got, want)
    assert masking.n_keep_patches(196, 0.5) == jax_masking.n_keep_patches(196, 0.5) == 98
    x = np.random.default_rng(6).standard_normal((3, 4, 16, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        masking.gather_tube_tokens(torch.from_numpy(x), torch.from_numpy(got)).numpy(),
        np.asarray(jax_masking.gather_tube_tokens(jnp.asarray(x), jnp.asarray(want))))


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_activations_match_jax(act):
    from tvts_tpu.models.layers import get_activation as jax_activation

    from tvts_torch.models.layers import get_activation

    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(get_activation(act)(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_activation(act)(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)


def test_unported_tower_options_raise():
    """The tower builds with every H/14 option; what stays unsupported, as in
    the JAX package, is LayerScale in the fused train forward, and an unknown
    pool style."""
    from tvts_torch.ops.fused_forward import space_time_vit_fused_train_forward

    for extra in ({"ls_init": 0.1}, {"patch_dropout": 0.5}, {"attentional_pool": True}):
        SpaceTimeViT(VisionConfig(**tiny_vision("openclip", **extra)))
    model = SpaceTimeViT(VisionConfig(**tiny_vision("openclip", ls_init=0.1)))
    with pytest.raises(NotImplementedError):
        space_time_vit_fused_train_forward(model, torch.zeros(1, 4, 3, 32, 32))
    with pytest.raises(ValueError):
        SpaceTimeViT(VisionConfig(**tiny_vision("mean")))
