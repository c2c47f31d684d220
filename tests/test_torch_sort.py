"""The port's transcript-sorting head on the CPU against the JAX package: the
eager SortTransformer, trimmed and untrimmed, against the flax module; the
fused forward (H7 plain version, non-causal, LN eps 1e-6) against the JAX
fused forward in interpret mode; and the sort head's weights through the
converter. float32, atol 3e-5 / rtol 1e-4 (summation order only); every
parameter carries seeded noise (type_embed is zero at init)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_text import jax_tvts, port_tvts
from tests.test_torch_vit import ATOL, RTOL
from tvts_torch.models.configs import SortConfig
from tvts_torch.models.sort import SortTransformer
from tvts_torch.ops.text_attention import sort_transformer_fused_forward
from tvts_torch.utils.convert import state_dict_from_jax

SORT = dict(embed_dim=64, depth=2, num_heads=4, num_classes=4)


def _sort_inputs(seed, B=2, n_text=4, S=9, D=64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, n_text, D)).astype(np.float32),
            rng.standard_normal((B, S, D)).astype(np.float32))


def _jax_sort(seed=0):
    from tvts_tpu.models.configs import SortConfig as JaxSortConfig
    from tvts_tpu.models.sort import SortTransformer as JaxSortTransformer

    module = JaxSortTransformer(JaxSortConfig(**SORT))
    text, video = _sort_inputs(seed)
    params = module.init(jax.random.PRNGKey(seed), jnp.asarray(text), jnp.asarray(video))["params"]
    noise = np.random.default_rng(seed + 1)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * noise.normal(size=a.shape).astype(np.float32), params)
    return module, params


def _port_sort(params, trim_last=True) -> SortTransformer:
    model = SortTransformer(SortConfig(**SORT), trim_last=trim_last)
    sd = state_dict_from_jax({"pred_model": params})
    model.load_state_dict({k.removeprefix("pred_model."): torch.from_numpy(v)
                           for k, v in sd.items()}, strict=True)
    return model.eval()


@pytest.mark.parametrize("trim", [True, False])
def test_sort_transformer_matches_flax(monkeypatch, trim):
    module, params = _jax_sort(seed=1)
    text, video = _sort_inputs(2)
    monkeypatch.setenv("TVTS_SORT_TAIL", "1" if trim else "0")
    want = module.apply({"params": params}, jnp.asarray(text), jnp.asarray(video))
    with torch.no_grad():
        got = _port_sort(params, trim_last=trim)(torch.from_numpy(text), torch.from_numpy(video))
    assert got.shape == (2, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_sort_fused_forward_matches_jax_fused():
    from tvts_tpu.models.configs import SortConfig as JaxSortConfig
    from tvts_tpu.ops.pallas_text_attention import (
        sort_transformer_fused_forward as jax_fused,
    )

    _, params = _jax_sort(seed=3)
    text, video = _sort_inputs(4)
    want = jax_fused(params, JaxSortConfig(**SORT), jnp.asarray(text), jnp.asarray(video),
                     dtype=jnp.float32, interpret=True)
    model = _port_sort(params)
    with torch.no_grad():
        got = sort_transformer_fused_forward(model, torch.from_numpy(text),
                                             torch.from_numpy(video))
        eager = model(torch.from_numpy(text), torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), atol=ATOL, rtol=RTOL)


def test_sort_head_weights_through_the_converter():
    """The full tree's pred_model.* keys are the port module's, shape for
    shape, and load strictly into the container (fc1/fc2, norm1/norm2,
    type_embed [1, 2, D])."""
    from tvts_tpu.utils.torch_convert import export_state_dict

    _, params, cfg = jax_tvts()
    got = state_dict_from_jax(params)
    assert list(got) == list(export_state_dict(params, ddp_prefix=False))
    head = {k: v.shape for k, v in got.items() if k.startswith("pred_model.")}
    model = port_tvts(params)
    assert head == {k: tuple(v.shape) for k, v in model.state_dict().items()
                    if k.startswith("pred_model.")}
    assert head["pred_model.type_embed"] == (1, 2, cfg.sort.embed_dim)
    assert "pred_model.blocks.0.mlp.fc1.weight" in head
    torch.testing.assert_close(model.pred_model.type_embed,
                               torch.from_numpy(got["pred_model.type_embed"]))
