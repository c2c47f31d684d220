"""Weights carried from the JAX package into tvts_torch: `state_dict_from_jax`
equals `export_state_dict(params, ddp_prefix=False)` key for key and value for
value, the port's tower loads it strictly, and a reference `.pth` of a full
TVTSv2 tree loads through `build_model` (strictly, the sort head included: a
video-only one is refused), which builds on the card unless asked for the CPU."""

import numpy as np
import pytest
import torch

from tests.test_torch_text import jax_tvts, tiny_text
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
                               text=configs.TextConfig(**tiny_text()),
                               sort=configs.SortConfig(embed_dim=48, num_heads=4))
    monkeypatch.setitem(configs.MODEL_REGISTRY, "tiny", lambda: cfg)


def test_build_model_loads_reference_pth(monkeypatch, tmp_path):
    from tvts_tpu.utils.torch_convert import save_reference_checkpoint

    _tiny_registry(monkeypatch)
    _, params, _ = jax_tvts()
    path = str(tmp_path / "tiny.pth")
    save_reference_checkpoint(params, path, arch="tiny")
    sd = load_reference_state_dict(path)  # `module.` stripped
    want = state_dict_from_jax(params)
    assert set(sd) == set(want)
    cfg, model = build_model("tiny", load_checkpoint=path, device="cpu")
    assert cfg.vision.mask_ratio == 0.0 and not model.training
    assert set(model.state_dict()) == set(want)
    for key, value in want.items():  # the sort head too
        np.testing.assert_array_equal(model.state_dict()[key].numpy(), value, err_msg=key)
    video_only = str(tmp_path / "video_only.pth")
    save_reference_checkpoint({"video_model": params["video_model"]}, video_only, arch="tiny")
    with pytest.raises(RuntimeError, match="text_token_embedding"):
        build_model("tiny", load_checkpoint=video_only, device="cpu")


def test_build_model_seeded_init_and_dtype(monkeypatch):
    _tiny_registry(monkeypatch)
    _, a = build_model("tiny", seed=3, device="cpu")
    _, b = build_model("tiny", seed=3, device="cpu")
    _, c = build_model("tiny", seed=4, dtype=torch.bfloat16, device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.video_model.proj, c.video_model.proj.float())
    assert not torch.equal(a.text_projection, c.text_projection.float())
    blk = c.video_model.transformer.resblocks[0]
    # the reference time-attention init, and f32 LayerNorms inside a bf16 tower
    assert not blk.timeattn.qkv.weight.any() and bool((blk.timeattn.proj.weight == 1).all())
    assert blk.attn.qkv.weight.dtype == torch.bfloat16
    assert blk.ln_3.weight.dtype == c.video_model.ln_pre.weight.dtype == torch.float32
    text_blk = c.text_model.resblocks[0]
    assert text_blk.attn.in_proj_weight.dtype == c.text_token_embedding.weight.dtype \
        == torch.bfloat16
    assert text_blk.ln_1.weight.dtype == c.text_ln_final.weight.dtype == torch.float32


def test_build_model_defaults_to_the_card(monkeypatch):
    """The port's entry point runs on the card unless the caller asks for the
    CPU: without a CUDA device the default raises instead of falling back."""
    import inspect

    _tiny_registry(monkeypatch)
    assert inspect.signature(build_model).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model("tiny")
    cfg, model = build_model("tiny", eval_mode=False, device="cpu")
    assert cfg.vision.mask_ratio == 0.5 and model.training  # the masked training config
