"""Weights carried from the JAX package into tvts_torch: `state_dict_from_jax`
equals `export_state_dict(params, ddp_prefix=False)` key for key and value for
value, the port's tower loads it strictly, and a reference `.pth` loads
through `build_model`."""

import numpy as np
import pytest
import torch

from tests.test_torch_vit import jax_params, port_model, tiny_vision
from tvts_torch.models import configs
from tvts_torch.models.factory import build_model
from tvts_torch.utils.convert import load_reference_state_dict, state_dict_from_jax


@pytest.mark.parametrize("pool", ["openai", "openclip"])
def test_state_dict_from_jax_equals_export(pool):
    from tvts_tpu.utils.torch_convert import export_state_dict

    _, params = jax_params(tiny_vision(pool))
    want = export_state_dict({"video_model": params}, ddp_prefix=False)
    got = state_dict_from_jax({"video_model": params})
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype == np.float32
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    bare = state_dict_from_jax(params)  # the tower's own tree: no prefix
    assert {f"video_model.{k}" for k in bare} == set(want)
    # a reference name, e.g. block 1's time attention
    assert "video_model.transformer.resblocks.1.timeattn.qkv.weight" in got
    assert got["video_model.conv1.weight"].shape == (64, 3, 16, 16)


def test_port_tower_loads_strictly_with_reference_names():
    _, params = jax_params(tiny_vision())
    model = port_model(tiny_vision(), params)
    assert set(model.state_dict()) == set(state_dict_from_jax(params))
    with pytest.raises(RuntimeError):
        model.load_state_dict({"extra": torch.zeros(1)}, strict=True)


def _tiny_registry(monkeypatch, pool="openai"):
    cfg = configs.TVTSv2Config(name="tiny", vision=configs.VisionConfig(**tiny_vision(pool)),
                               text=configs.TextConfig(), sort=configs.SortConfig())
    monkeypatch.setitem(configs.MODEL_REGISTRY, "tiny", lambda: cfg)


def test_build_model_loads_reference_pth(monkeypatch, tmp_path):
    from tvts_tpu.utils.torch_convert import save_reference_checkpoint

    _tiny_registry(monkeypatch)
    _, params = jax_params(tiny_vision())
    path = str(tmp_path / "tiny.pth")
    save_reference_checkpoint({"video_model": params}, path, arch="tiny")
    sd = load_reference_state_dict(path)  # `module.` stripped
    assert set(sd) == {f"video_model.{k}" for k in state_dict_from_jax(params)}
    cfg, model = build_model("tiny", load_checkpoint=path)
    assert cfg.vision.mask_ratio == 0.0 and not model.training
    for key, value in state_dict_from_jax(params).items():
        np.testing.assert_array_equal(model.state_dict()[key].numpy(), value, err_msg=key)


def test_build_model_seeded_init_and_dtype(monkeypatch):
    _tiny_registry(monkeypatch)
    _, a = build_model("tiny", seed=3)
    _, b = build_model("tiny", seed=3)
    _, c = build_model("tiny", seed=4, dtype=torch.bfloat16)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.proj, c.proj.float())
    blk = c.transformer.resblocks[0]
    # the reference time-attention init, and f32 LayerNorms inside a bf16 tower
    assert not blk.timeattn.qkv.weight.any() and bool((blk.timeattn.proj.weight == 1).all())
    assert blk.attn.qkv.weight.dtype == torch.bfloat16
    assert blk.ln_3.weight.dtype == c.ln_pre.weight.dtype == torch.float32
