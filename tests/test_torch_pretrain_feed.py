"""The pretraining data feed on the CPU against the JAX package: the MLM
collator and dict-of-lists collate (same generator seed, equal arrays),
`clip_tokenize_fn` and `prepare_batch` on a YT-Temporal and a WebVid batch
(equal arrays; the fast path for pre-tokenized batches casts and drops
strings, a repair of the JAX package's pass-through), and the slice as a
whole at a tiny arch: the repo's pretraining config file with its two
loaders over a tiny synthesized YT-Temporal + WebVid layout -> prepare_batch
-> prefetch_to_device(device="cpu") -> the train step under the config's
kernel preset (the kernels' plain versions on the CPU), its loss within 2e-5
of the JAX step's on the same batch and weights (exported with
export_state_dict), float32."""

import copy
import functools
import random
from functools import partial

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from tvts_torch.data import collate as port_collate  # noqa: E402
from tvts_torch.data.prefetch import prefetch_to_device  # noqa: E402
from tvts_torch.train.trainer import clip_tokenize_fn, prepare_batch  # noqa: E402

LOSS_ATOL = 2e-5  # f32: the port's step against the JAX step on the same batch


# ---------------------------------------------------------------------------
# the MLM collator (dead code in both packages' trainers, ported for parity)
# ---------------------------------------------------------------------------
def _encodings(rng, n):
    return [{"input_ids": rng.integers(0, 50, rng.integers(1, 12)).tolist(),
             **({"attention_mask": [1] * 3} if i % 2 else {})} for i in range(n)]


def test_mlm_collator_equals_jax():
    from tvts_tpu.data.collate import MLMCollator as JaxMLMCollator

    encs = _encodings(np.random.default_rng(0), 9)
    kw = dict(vocab_size=50, mask_token_id=49, special_ids=(0, 1), mlm_probability=0.4)
    got = port_collate.MLMCollator(**kw, rng=np.random.default_rng(3))(encs)
    want = JaxMLMCollator(**kw, rng=np.random.default_rng(3))(encs)
    assert list(got) == list(want) == ["input_ids", "labels"]
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    assert (got["labels"] != -100).any()


def test_mlm_collate_equals_jax():
    from tvts_tpu.data import collate as jax_collate

    rng = np.random.default_rng(1)
    encs = _encodings(rng, 6)
    batch = [{"image": [rng.standard_normal((2, 3, 8 + i, 10 - i)).astype(np.float32)
                        for _ in range(2)],
              "text": (f"caption {i}", encs[i]), "false_text_0": (f"other {i}", encs[3 + i]),
              "id": i} for i in range(3)]
    kw = dict(vocab_size=50, mask_token_id=49, special_ids=(0,))
    got = port_collate.mlm_collate(copy.deepcopy(batch), 2,
                                   port_collate.MLMCollator(**kw, rng=np.random.default_rng(4)))
    want = jax_collate.mlm_collate(copy.deepcopy(batch), 2,
                                   jax_collate.MLMCollator(**kw, rng=np.random.default_rng(4)))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if key == "image":
            assert len(got[key]) == len(w) == 2
            for g, ww in zip(got[key], w):
                assert g.shape == (3, 2, 3, 10, 10)
                np.testing.assert_array_equal(g, ww)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key
    with pytest.raises(ValueError, match="Collate error"):
        port_collate.mlm_collate([{"image": [np.zeros((3, 8, 8))]}], 1,
                                 port_collate.MLMCollator(**kw))


# ---------------------------------------------------------------------------
# the tiny pretraining layout and config
# ---------------------------------------------------------------------------
RES, PATCH = 32, 16  # the tiny arch: 4 patches a frame, 2 kept at mask 0.5


@pytest.fixture(scope="module")
def feed(tmp_path_factory):
    """(config path) of the repo's pretraining config over 4 YT-Temporal and 4
    WebVid clips, batch 2, 2 workers, read with cv2."""
    root = str(tmp_path_factory.mktemp("pretrain_feed"))
    path, specs = chip_smoke.pretrain_trees(
        root, {"num_workers": 2, "batch_size": 2, "reader": "cv2",
               "patches_per_frame": (RES // PATCH) ** 2},
        {"input_res": RES}, ytt=(4, 30, 2, (48, 64)), webvid=(4, 4, 4, (48, 64)))
    chip_smoke.write_clips(specs, 2)
    return path


def _loaders(config_path, pkg="tvts_torch", **overrides):
    import importlib

    config_mod = importlib.import_module(f"{pkg}.utils.config")
    config = config_mod.ConfigParser(config_mod.read_json(config_path), test=True)
    return [config.initialize_dataset_loader(spec, overrides)[1]
            for spec in config["data_loader"]]


def _first_batches(config_path, seed=0, pkg="tvts_torch"):
    random.seed(seed)
    np.random.seed(seed)
    return [next(iter(loader)) for loader in _loaders(config_path, pkg, num_workers=0)]


def test_config_builds_both_loaders_and_their_batches(feed):
    ytt, web = _loaders(feed)
    assert (type(ytt.dataset).__name__, type(web.dataset).__name__) == ("YTTemporal", "WebVid")
    assert (ytt.batch_size, ytt.num_workers, web.batch_size) == (2, 2, 2)
    yb, wb = _first_batches(feed)
    assert yb["video"].shape == (2, 12, 3, RES, RES) and wb["video"].shape == (2, 12, 3, RES, RES)
    assert len(yb["text"]) == 4 and all(len(clip) == 2 for clip in yb["text"])  # clip-major
    np.testing.assert_array_equal(yb["label"], np.tile(np.arange(4), (2, 1)))
    assert yb["keep_ind"].shape == (2, 2) and "label" not in wb
    jy, jw = _first_batches(feed, pkg="tvts_tpu")  # the JAX package's loaders agree
    for got, want in ((yb, jy), (wb, jw)):
        np.testing.assert_array_equal(got["video"], want["video"])
        assert got["text"] == want["text"] and got["meta"] == want["meta"]


def test_prepare_batch_and_clip_tokenize_fn_equal_jax(feed):
    from tvts_tpu.train import trainer as jax_trainer

    for batch in _first_batches(feed, seed=1):
        got, want = prepare_batch(batch), jax_trainer.prepare_batch(batch)
        assert list(got) == list(want)
        for key, w in want.items():
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
    yb, wb = _first_batches(feed, seed=1)
    got = prepare_batch(yb)
    assert got["text_ids"].shape == (8, 77) and got["labels"].shape == (2, 4)
    flat = [cap for clip in yb["text"] for cap in clip]  # clip-major: clip 0 of every sample first
    np.testing.assert_array_equal(got["text_ids"], clip_tokenize_fn()(flat)["text_ids"])
    for n in (77, 16):
        texts = ["a person plays", "x " * 100, ""]
        np.testing.assert_array_equal(clip_tokenize_fn(n)(texts)["text_ids"],
                                      jax_trainer.clip_tokenize_fn(n)(texts)["text_ids"])
    assert prepare_batch(wb)["text_ids"].shape == (2, 77) and "labels" not in prepare_batch(wb)


def test_prepare_batch_fast_path_casts_and_drops_what_is_not_numeric():
    """Repair of the JAX package (trainer.py:68-69 returns a pre-tokenized
    batch as it is): the casts of the tokenizing path, no strings or meta."""
    batch = {"video": np.zeros((2, 3), np.float64), "keep_ind": np.arange(4).reshape(2, 2),
             "text_ids": np.ones((8, 5), np.int64), "label": np.tile(np.arange(4), (2, 1)),
             "text": [["a", "b"]] * 4, "meta": [{"paths": "x"}] * 2, "ragged": [[1], [2, 3]],
             "weights": [0.5, 1.5]}
    out = prepare_batch(batch)
    assert sorted(out) == ["keep_ind", "labels", "text_ids", "video", "weights"]
    assert (out["video"].dtype, out["keep_ind"].dtype, out["labels"].dtype) == \
        (np.float32, np.int32, np.int32)
    np.testing.assert_array_equal(out["text_ids"], batch["text_ids"])


# ---------------------------------------------------------------------------
# the slice: config -> loaders -> prepare_batch -> prefetch -> train step
# ---------------------------------------------------------------------------
def _tiny_configs():
    from tvts_tpu.models import configs as jc
    from tvts_torch.models import configs as pc

    def make(m):
        return m.TVTSv2Config(
            name="tiny", vision=m.VisionConfig(
                input_resolution=RES, patch_size=PATCH, width=64, layers=2, heads=4,
                output_dim=48, num_frames=12, mask_ratio=0.5, pool_style="openai",
                act="quick_gelu"),
            text=m.TextConfig(context_length=77, vocab_size=49408, width=64, layers=2, heads=4,
                              output_dim=48),
            sort=m.SortConfig(embed_dim=48, num_heads=4, num_classes=4))

    return make(jc), make(pc)


@functools.cache
def _jax_model():
    """(flax TVTSv2 of the tiny config, params with seeded noise)."""
    import jax

    from tvts_tpu.models.tvts_v2 import TVTSv2

    jcfg, _ = _tiny_configs()
    model = TVTSv2(jcfg)
    v = jcfg.vision
    params = model.init(jax.random.PRNGKey(0),
                        np.zeros((1, 12, 3, RES, RES), np.float32),
                        np.zeros((4, 77), np.int32), np.zeros((1, v.n_keep), np.int32))["params"]
    noise = np.random.default_rng(2)
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.02 * noise.normal(size=a.shape).astype(np.float32), params)
    return model, params


def test_slice_config_to_train_step_matches_jax(feed):
    import jax

    from tvts_tpu.train.step import make_loss_fn as jax_make_loss_fn
    from tvts_tpu.utils.torch_convert import export_state_dict
    from tvts_torch.models.tvts_v2 import TVTSv2
    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.ops.kernel_config import resolve_kernel_config, train_apply_kwargs
    from tvts_torch.train.optim import OptimizerConfig, make_optimizer
    from tvts_torch.train.step import make_loss_fn, make_train_step
    from tvts_torch.utils.config import ConfigParser, read_json

    config = ConfigParser(read_json(feed), test=True)
    jmodel, params = _jax_model()
    _, pcfg = _tiny_configs()
    model = TVTSv2(pcfg)
    model.load_state_dict({k: torch.from_numpy(np.asarray(a)) for k, a in
                           export_state_dict(params, ddp_prefix=False).items()}, strict=True)
    model.train()
    ocfg = OptimizerConfig(text_layers=2, text_tune_layers=1)
    kcfg = resolve_kernel_config(config["arch"]["type"], config["trainer"]["kernels"], env={})
    kwargs = train_apply_kwargs(kcfg, ocfg)
    assert (kcfg["space_mode"], kcfg["time_mode"], kcfg["text_mode"], kcfg["sort_mode"]) == \
        ("pallas_v10", "pallas_tps", "pallas", "pallas")
    apply_fn = partial(train_apply, **kwargs)

    random.seed(3)
    np.random.seed(3)
    ytt, web = _loaders(feed)  # 2 workers, threads
    host = [prepare_batch(next(iter(ytt))), prepare_batch(next(iter(web)))]
    fed = list(prefetch_to_device(iter(host), size=2, device="cpu"))
    assert [b["text_ids"].shape[0] for b in fed] == [8, 2] and "labels" not in fed[1]
    jax_loss = jax.jit(lambda p, b: jax_make_loss_fn(jmodel)(p, b)[0])
    losses = []
    for batch, hb in zip(fed, host):
        for key, arr in hb.items():
            np.testing.assert_array_equal(batch[key].numpy(), arr)
        want = float(jax_loss(params, hb))
        got, _ = make_loss_fn(apply_fn=apply_fn)(model, batch)
        np.testing.assert_allclose(got.item(), want, atol=LOSS_ATOL, rtol=0)
        losses.append(want)
    step = make_train_step(model, make_optimizer(model, ocfg), ocfg, apply_fn=apply_fn)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    aux = step(fed[0])
    np.testing.assert_allclose(aux["loss"].item(), losses[0], atol=LOSS_ATOL, rtol=0)
    assert aux["loss_ce"].item() > 0  # the YT-Temporal batch runs the sort head
    moved = [n for n, p in model.named_parameters() if not torch.equal(p, before[n])]
    assert moved and "text_model.resblocks.0.mlp.c_fc.weight" not in moved  # block 0 frozen
