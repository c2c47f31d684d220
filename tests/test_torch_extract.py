"""The port's extraction slice on the CPU: the fused forward (plain versions of
the kernels) against the JAX fused forward (kernel_version 7, interpret mode)
and against flax `apply`; build_model + extract_embeddings on a ragged loader;
extract_video_feature; and the package's independence from JAX, `regex` and
`pandas`."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_text import jax_tvts, port_tvts, tiny_text
from tests.test_torch_vit import ATOL, RTOL, jax_params, port_model, tiny_inputs, tiny_vision
from tvts_torch.eval.embed import extract_embeddings, make_embed_fns
from tvts_torch.eval.feature_extraction import extract_video_feature
from tvts_torch.ops.fused_forward import space_time_vit_fused_forward

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("pool", ["openai", "openclip"])
def test_fused_forward_cls_only_matches_jax_fused_and_apply(pool):
    from tvts_tpu.models.configs import VisionConfig as JaxVisionConfig
    from tvts_tpu.ops.fused_forward import space_time_vit_fused_forward as jax_fused

    kw = tiny_vision(pool)
    module, params = jax_params(kw, seed=2)
    video, keep = tiny_inputs(4)
    want_apply, _ = module.apply({"params": params}, jnp.asarray(video), jnp.asarray(keep))
    want_fused, _ = jax_fused(params, JaxVisionConfig(**kw), jnp.asarray(video),
                              jnp.asarray(keep), dtype=jnp.float32, kernel_version=7,
                              space_fpp=2, need_tokens=False, interpret=True)
    with torch.no_grad():
        got, tokens = space_time_vit_fused_forward(
            port_model(kw, params), torch.from_numpy(video), torch.from_numpy(keep),
            need_tokens=False)
    assert tokens is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want_fused), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_apply), atol=ATOL, rtol=RTOL)


def test_fused_forward_tokens_match_apply():
    kw = tiny_vision("openai")
    module, params = jax_params(kw, seed=5)
    video, keep = tiny_inputs(6)
    want_p, want_t = module.apply({"params": params}, jnp.asarray(video), jnp.asarray(keep))
    with torch.no_grad():
        got_p, got_t = space_time_vit_fused_forward(
            port_model(kw, params), torch.from_numpy(video), torch.from_numpy(keep))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), atol=ATOL, rtol=RTOL)


class _Loader:
    def __init__(self, video, keep, batch_size):
        self.video, self.keep, self.batch_size = video, keep, batch_size

    def __iter__(self):
        for i in range(0, len(self.video), self.batch_size):
            yield {"video": self.video[i:i + self.batch_size],
                   "keep_ind": self.keep[i:i + self.batch_size],
                   "label": np.arange(i, min(i + self.batch_size, len(self.video))),
                   "meta": [f"clip{j}" for j in range(i, min(i + self.batch_size,
                                                              len(self.video)))]}


@pytest.mark.parametrize("use_fused", [False, True])
def test_build_model_extract_embeddings_ragged_loader(monkeypatch, use_fused):
    from tvts_torch.models import configs
    from tvts_torch.models.factory import build_model

    cfg0 = configs.TVTSv2Config(name="tiny", vision=configs.VisionConfig(**tiny_vision()),
                                text=configs.TextConfig(**tiny_text()),
                                sort=configs.SortConfig(embed_dim=48, num_heads=4))
    monkeypatch.setitem(configs.MODEL_REGISTRY, "tiny", lambda: cfg0)
    cfg, model = build_model("tiny", seed=1, device="cpu")
    with torch.no_grad():  # noise on every leaf: the time attention is zero at init
        rng = np.random.default_rng(7)
        for p in model.parameters():
            p.add_(torch.from_numpy(0.02 * rng.standard_normal(p.shape).astype(np.float32)))
    video, _ = tiny_inputs(8, batch=7)
    keep = np.tile(np.arange(4, dtype=np.int32), (7, 1))
    out = extract_embeddings(model, _Loader(video, keep, batch_size=3), use_fused=use_fused,
                             kernel_version=7, space_fpp=3)
    assert out["video"].shape == (7, cfg.vision.output_dim)
    np.testing.assert_array_equal(out["labels"], np.arange(7))
    assert out["metas"] == [f"clip{j}" for j in range(7)]
    with torch.no_grad():
        want, _ = model.compute_video(torch.from_numpy(video), torch.from_numpy(keep))
    np.testing.assert_allclose(out["video"], want.numpy(), atol=ATOL, rtol=RTOL)
    assert "text" not in out  # the batches carry no captions
    with pytest.raises(TypeError):
        make_embed_fns(model, use_fused=True, not_a_knob=1)


def _pooler_tvts(monkeypatch, **extra):
    """A tiny TVTSv2 whose video tower (the tiny_vision("openclip") geometry)
    has the attentional pooler, weights reset from seed 0 plus 0.02 noise."""
    from tvts_torch.models import configs
    from tvts_torch.models.factory import build_model

    vision = configs.VisionConfig(**{**tiny_vision("openclip", **extra), "mask_ratio": 0.0})
    cfg0 = configs.TVTSv2Config(name="tiny_pooler", vision=vision,
                                text=configs.TextConfig(**tiny_text()),
                                sort=configs.SortConfig(embed_dim=48, num_heads=4))
    monkeypatch.setitem(configs.MODEL_REGISTRY, "tiny_pooler", lambda: cfg0)
    _, model = build_model("tiny_pooler", seed=0, device="cpu")
    with torch.no_grad():
        rng = np.random.default_rng(1)
        for p in model.parameters():
            p.add_(torch.from_numpy(0.02 * rng.standard_normal(p.shape).astype(np.float32)))
    return model


@pytest.mark.parametrize("extra", [dict(n_queries=6, attn_pooler_heads=4),
                                   dict(n_queries=5, attn_pooler_heads=2, ls_init=0.3)],
                         ids=["pooler", "pooler+layerscale"])
def test_attentional_pooler_tower_stays_exact_through_make_embed_fns(monkeypatch, extra):
    """The pooler cross-attends every token, so the CLS-only fused tail cannot
    serve it: make_embed_fns(use_fused=True) keeps such a tower eager (equal to
    compute_video), and the fused forward without tokens refuses it rather
    than pooling one row; with tokens it stays exact."""
    model = _pooler_tvts(monkeypatch, attentional_pool=True, **extra)
    video = torch.from_numpy(tiny_inputs(2)[0])
    keep = torch.arange(4)[None].expand(2, -1)
    with torch.no_grad():
        want, _ = model.compute_video(video, keep)
        for use_fused in (False, True):
            _, embed_video = make_embed_fns(model, use_fused=use_fused)
            torch.testing.assert_close(embed_video(video, keep), want, rtol=0, atol=0)
        with pytest.raises(NotImplementedError, match="attentional pooler"):
            space_time_vit_fused_forward(model.video_model, video, keep, need_tokens=False)
        if "ls_init" not in extra:  # the fused tower reads no LayerScale gammas
            got, _ = space_time_vit_fused_forward(model.video_model, video, keep)
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=RTOL)


def test_extract_video_feature_full_keep_set():
    model, params, _ = jax_tvts()
    video, _ = tiny_inputs(10, batch=1)
    want, _ = model.apply({"params": params}, jnp.asarray(video),
                          jnp.arange(4, dtype=jnp.int32)[None],
                          method=lambda m, v, k: m.compute_video(v, k))
    got = extract_video_feature(port_tvts(params), video, use_fused=True)
    assert got.shape == (1, 48) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_tvts_torch_imports_no_jax():
    """Every tvts_torch module, and chip_smoke.py, imports without pulling in
    jax, flax, optax, orbax, tvts_tpu, regex or pandas, none of which the
    card's machine has, nor cv2 or PIL: the data layer imports cv2 only when
    its cv2 backend runs (data/image_datasets.py only inside decode_image,
    which decodes what the JAX package opens with PIL), and PIL never (a
    subprocess: this test process already holds jax through conftest)."""
    code = (
        "import importlib, pkgutil, sys, tvts_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(tvts_torch.__path__, 'tvts_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] "
        "       in ('jax', 'flax', 'optax', 'orbax', 'tvts_tpu', 'regex', 'pandas', 'cv2',"
        "           'PIL'))\n"
        "assert not bad, bad\n"
        "print(' '.join(n for n in sys.modules if n.startswith('tvts_torch')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    imported = set(proc.stdout.split())
    assert len(imported) >= 100  # every module of the package was imported
    assert {"tvts_torch.train.optim", "tvts_torch.train.step", "tvts_torch.ops.losses",
            "tvts_torch.ops.kernel_config", "tvts_torch.ops.block_backward",
            "tvts_torch.models.sort"} <= imported
    assert {"tvts_torch.data", "tvts_torch.data.datasets", "tvts_torch.data.loader",
            "tvts_torch.data.transforms", "tvts_torch.data.video_reader",
            "tvts_torch.data.native_decoder", "tvts_torch.ops.sampling",
            "tvts_torch.utils.config", "tvts_torch.cli.feature_extraction",
            "tvts_torch.cli.zero_ret", "tvts_torch.cli.zero_recognition",
            "tvts_torch.cli.zero_ssv2_mc", "tvts_torch.cli.zero_ret_ViT_H_14"} <= imported
    assert {"tvts_torch.data.asr", "tvts_torch.data.ytt", "tvts_torch.data.collate",
            "tvts_torch.data.prefetch", "tvts_torch.train.trainer"} <= imported
    assert {"tvts_torch.cli.train_dist_TVTSv2", "tvts_torch.cli.train_dist_TVTSv2_ViT_H_14",
            "tvts_torch.parallel.mesh", "tvts_torch.parallel.collectives",
            "tvts_torch.parallel.partition", "tvts_torch.utils.checkpoint",
            "tvts_torch.utils.logging", "tvts_torch.utils.tb_events",
            "tvts_torch.utils.visualizer", "tvts_torch.utils.profiling"} <= imported
    assert {"tvts_torch.text.wordpiece", "tvts_torch.models.distilbert",
            "tvts_torch.models.joint_vit", "tvts_torch.models.tvts_v1",
            "tvts_torch.data.image_datasets", "tvts_torch.cli.train_dist_TVTS"} <= imported
    assert {"tvts_torch.downstream.randaug", "tvts_torch.downstream.mixup",
            "tvts_torch.downstream.random_erasing", "tvts_torch.downstream.cls_dataset",
            "tvts_torch.downstream.model", "tvts_torch.downstream.engine",
            "tvts_torch.downstream.zero_v2v", "tvts_torch.cli.run_class_finetuning",
            "tvts_torch.cli.run_class_linear", "tvts_torch.cli.run_class_zero"} <= imported
    assert {"tvts_torch.parallel.sequence_parallel", "tvts_torch.data.clip_transforms",
            "tvts_torch.downstream.video_transforms",
            "tvts_torch.downstream.video_transformer"} <= imported
