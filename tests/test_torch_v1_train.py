"""TVTS v1 training on the CPU against the JAX package:
- three steps of the port's single-group AdamW (`make_v1_optimizer`, weight
  decay > 0, a milestone after step 2) against the JAX `make_train_step` with
  scripts/train_dist_TVTS.py's `optax.adamw`: every step's loss and the
  parameters after within 2e-5 (the attention k biases apart: their
  gradient is rounding noise);
- tvts_torch/cli/train_dist_TVTS.py against scripts/train_dist_TVTS.py on the
  repo's v1-dist-yt-pt.json over a tiny cv2-written YT-Temporal tree
  (chip_smoke.pretrain_trees), a tiny arch injected into both and f32 in both,
  the same seeded `.pth` loaded through `load_checkpoint`, `random.seed`
  before each run: every step's loss within 2e-5, two epochs across the
  `--schedule 1` milestone; the port's epoch file rebuilt strictly;
- both refusing v1-dist-cc-web-pt.json: the JAX script with a TypeError at
  the WebVid loader, and JointViT on the 2-D keep set CC3M gives; the port
  by name before any loader.
One thread; the JAX steps run jitted."""

import dataclasses
import json
import random
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from tests.test_torch_cli import load_script  # noqa: E402
from tests.test_torch_trainer import one_device_mesh  # noqa: E402
from tests.test_torch_v1 import B, inputs, jax_module, tiny_config  # noqa: E402
from tests.test_wordpiece import VOCAB  # noqa: E402
from tvts_torch.models import distilbert as port_distilbert  # noqa: E402
from tvts_torch.models import tvts_v1 as port_v1  # noqa: E402
from tvts_torch.utils import convert as port_convert  # noqa: E402

LOSS_ATOL = 2e-5
TREE_B = 2  # the tiny tree's batch
N_YTT = 4  # YT-Temporal videos: 2 steps an epoch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# three AdamW steps
# ---------------------------------------------------------------------------
def test_three_adamw_steps_match_jax():
    import jax
    import optax

    from tvts_torch.train.optim import OptimizerConfig, make_v1_optimizer, milestone_scale_fn
    from tvts_torch.train.step import make_train_step

    jax_v1, jax_step = jax_module("models.tvts_v1"), jax_module("train.step")
    jax_optim = jax_module("train.optim")
    jcfg = tiny_config(jax_v1.TVTSv1Config, jax_module("models.distilbert").DistilBertConfig)
    pcfg = tiny_config(port_v1.TVTSv1Config, port_distilbert.DistilBertConfig)
    video, keep, ids, mask = inputs(pcfg, seed=3)
    labels = np.tile(np.arange(4, dtype=np.int32), (B, 1))
    jm = jax_v1.TVTSv1(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), video[:1], ids[:4], mask[:4],
                              keep[:1])["params"]
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.standard_normal(x.shape)
                          .astype(np.float32), params)
    # the script's optimizer: one group, lr x milestone scale, eps 1e-6, wd on every leaf
    lr, betas, wd = 1e-4, (0.9, 0.98), 0.05  # the lr of v1-dist-yt-pt.json
    scale = jax_optim.milestone_scale_fn(jax_optim.OptimizerConfig(schedule=(1,),
                                                                   steps_per_epoch=2))
    tx = optax.adamw(lambda step: lr * scale(step), b1=betas[0], b2=betas[1], eps=1e-6,
                     weight_decay=wd)
    state = jax_step.create_train_state(params, tx)
    step = jax_step.make_train_step(jm, tx, donate=False)
    batch = {"video": video, "text_ids": ids, "attention_mask": mask, "keep_ind": keep,
             "labels": labels}
    want = []
    for _ in range(3):
        state, aux = step(state, batch)
        want.append({k: float(v) for k, v in aux.items()})

    model = port_v1.TVTSv1(pcfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           port_convert.v1_state_dict_from_jax(params).items()}, strict=True)
    ocfg = OptimizerConfig(schedule=(1,), steps_per_epoch=2)
    assert [milestone_scale_fn(ocfg)(s) for s in range(3)] == [scale(s) for s in range(3)] \
        == [1, 1, pytest.approx(0.1)]
    opt = make_v1_optimizer(model, lr=lr, betas=betas, weight_decay=wd)
    assert len(opt.param_groups) == 1 and opt.param_groups[0]["weight_decay"] == wd
    train_step = make_train_step(model, opt, ocfg)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    got = [{k: v.item() for k, v in train_step(tb).items()} for _ in range(3)]
    assert train_step.count == 3 and opt.param_groups[0]["lr"] == pytest.approx(lr * 0.1)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=LOSS_ATOL), k
    assert got[0]["loss_ce"] > 0
    # every parameter but the attention k biases: softmax does not change when
    # a row's logits move together, so their gradient is zero but for
    # rounding, which Adam scales up to updates of either framework's noise
    trained = port_convert.v1_state_dict_from_jax(jax.tree.map(np.asarray, state.params))
    for name, value in model.state_dict().items():
        got_p, want_p = value.numpy(), trained[name]
        if name.endswith("k_lin.bias"):
            continue
        if name.endswith("attn.qkv.bias"):
            D = got_p.shape[0] // 3
            got_p, want_p = np.delete(got_p, np.s_[D:2 * D]), np.delete(want_p, np.s_[D:2 * D])
        np.testing.assert_allclose(got_p, want_p, atol=LOSS_ATOL, rtol=0, err_msg=name)


# ---------------------------------------------------------------------------
# the CLI twin against the JAX script
# ---------------------------------------------------------------------------
def _tiny(cfg_mod, bert_mod):
    """The config class the scripts call as TVTSv1Config(num_frames=...): the
    tiny arch at 32² (the tree's frames)."""

    cfg_cls, bert_cls = cfg_mod.TVTSv1Config, bert_mod.DistilBertConfig

    def make(num_frames=16):
        return dataclasses.replace(tiny_config(cfg_cls, bert_cls, num_frames), img_size=32)

    return make


def _f32_zero_init_jax(mp):
    """The JAX script's model in f32 (its --bf16 flag is always on) with its
    initial weights as zeros of their shapes (the checkpoint sets every one;
    the op-by-op init costs ~20 s)."""
    import jax
    import jax.numpy as jnp

    jax_v1 = jax_module("models.tvts_v1")
    base = jax_v1.TVTSv1

    class F32(base):
        def init(self, rngs, *args, **kwargs):
            shapes = jax.eval_shape(lambda: base.init(self, rngs, *args, **kwargs))
            return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    mp.setattr(jax_v1, "TVTSv1", lambda cfg, dtype=None: F32(cfg, dtype=jnp.float32))


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(root, the v2 pretraining config over a tiny YT-Temporal tree, vocab
    file, seeded v1 .pth)."""
    root = tmp_path_factory.mktemp("v1_train")
    path, specs = chip_smoke.pretrain_trees(
        str(root / "data"), {"num_workers": 0, "batch_size": TREE_B, "reader": "cv2"},
        {"input_res": 32}, ytt=(N_YTT, 30, 2, (48, 64)), webvid=(2, 4, 4, (48, 64)),
        words_s=0.5)
    chip_smoke.write_clips(specs, 4)
    vocab = root / "vocab.txt"
    vocab.write_text("\n".join(VOCAB + sorted(set(chip_smoke.WORDS))) + "\n")
    model = port_v1.TVTSv1(_tiny(port_v1, port_distilbert)())
    model.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(4)
    torch.save({k: v + 0.02 * torch.randn(v.shape, generator=gen)
                for k, v in model.state_dict().items()}, root / "init.pth")
    return root, path, str(vocab), str(root / "init.pth")


def _ytt_args(config_path):
    with open(config_path) as f:
        ytt = json.load(f)["data_loader"][0]["args"]
    return {k: ytt[k] for k in ("data_dir", "meta_root", "num_workers", "batch_size",
                                "reader")} | {"patches_per_frame": 4, "mask_ratio": 0.5,
                                              "video_params": {"input_res": 32,
                                                               "num_frames": 4, "loading": "lax"}}


def _v1_config(root, name, config_file, loaders, ckpt, **trainer):
    path = chip_smoke.v1_config(str(root / name), config_file, loaders,
                                {"epochs": 2, "save_dir": str(root / name[:-5]), **trainer})
    with open(path) as f:
        config = json.load(f)
    config["arch"]["args"]["load_checkpoint"] = ckpt
    with open(path, "w") as f:
        json.dump(config, f)
    return path


def _recorded(mp, module, name, out):
    """module.name (the JAX step factory) wrapped to record each step's aux."""
    original = getattr(module, name)

    def factory(*args, **kwargs):
        step = original(*args, **kwargs)

        def recorded(*a):
            state, aux = step(*a)
            out.append({k: float(v) for k, v in aux.items()})
            return state, aux

        return recorded

    mp.setattr(module, name, factory)


def test_cli_matches_jax_script(tree):
    from tvts_torch.cli import train_dist_TVTS as cli
    from tvts_torch.models.factory import build_v1_model
    from tvts_torch.train import step as step_mod

    root, base, vocab, ckpt = tree
    path = _v1_config(root, "yt.json", chip_smoke.V1_CONFIG, {"YTTemporal": _ytt_args(base)},
                      ckpt)
    argv = ["-c", path, "--bert_vocab", vocab, "--schedule", "1"]
    want, got = [], []
    mp = pytest.MonkeyPatch()
    try:
        _f32_zero_init_jax(mp)
        one_device_mesh(mp)
        mp.setattr(jax_module("models.tvts_v1"), "TVTSv1Config",
                   _tiny(jax_module("models.tvts_v1"), jax_module("models.distilbert")))
        _recorded(mp, jax_module("train.trainer"), "make_train_step", want)
        mp.setattr(sys, "argv", ["train_dist_TVTS", *argv])
        random.seed(1234)
        load_script("train_dist_TVTS").main()
    finally:
        mp.undo()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(cli, "TVTSv1Config", _tiny(port_v1, port_distilbert))
        call = step_mod.TrainStep.__call__

        def recorded(self, batch):
            aux = call(self, batch)
            got.append({k: float(v) for k, v in aux.items()})
            return aux

        mp.setattr(step_mod.TrainStep, "__call__", recorded)
        random.seed(1234)
        trainer = cli.main([*argv, "--no-bf16", "--device", "cpu"])
    finally:
        mp.undo()
    # 2 epochs x 2 YT-Temporal batches, the sort loss on in every step
    assert len(got) == len(want) == 2 * N_YTT // TREE_B == trainer.train_step.count
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["loss_ce"] > 0
        for k in w:
            assert g[k] == pytest.approx(w[k], abs=LOSS_ATOL), k
    assert trainer.optimizer.param_groups[0]["lr"] == pytest.approx(1e-4 * 0.1)
    epoch2 = trainer.ckpt.path("checkpoint-epoch2")
    model = build_v1_model(trainer.model.cfg, load_checkpoint=epoch2, device="cpu")
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key


def test_both_refuse_the_cc_web_config(tree, tmp_path):
    import cv2
    import jax

    from tvts_torch.cli import train_dist_TVTS as cli

    root, base, vocab, ckpt = tree
    cc = tmp_path / "cc3m"
    (cc / "training").mkdir(parents=True)
    assert cv2.imwrite(str(cc / "training" / "a.png"), np.full((40, 50, 3), 90, np.uint8))
    (cc / "cc3m_train.tsv").write_text("caption\tfilename\na grey image\ta.png\n")
    with open(base) as f:
        web = next(s["args"] for s in json.load(f)["data_loader"]
                   if s["args"]["dataset_name"] == "WebVid")
    small = {"batch_size": 1, "num_workers": 0, "patches_per_frame": 4,
             "video_params": {"input_res": 32, "num_frames": 2, "loading": "lax"}}
    path = _v1_config(tmp_path, "cc_web.json", chip_smoke.V1_CC_CONFIG, {
        "ConceptualCaptions3M": {"data_dir": str(cc), "meta_root": str(cc), **small},
        "WebVid": {"data_dir": web["data_dir"], "meta_root": web["meta_root"], **small}}, ckpt)
    mp = pytest.MonkeyPatch()
    try:
        _f32_zero_init_jax(mp)
        one_device_mesh(mp)
        mp.setattr(jax_module("models.tvts_v1"), "TVTSv1Config",
                   _tiny(jax_module("models.tvts_v1"), jax_module("models.distilbert")))
        mp.setattr(sys, "argv", ["train_dist_TVTS", "-c", path, "--bert_vocab", vocab])
        with pytest.raises(TypeError, match="per_tube_masks"):
            load_script("train_dist_TVTS").main()
    finally:
        mp.undo()
    # the second fault: CC3M's keep set is [B, n_keep]; JointViT takes [B, n_tubes, n_keep]
    jax_v1 = jax_module("models.tvts_v1")
    jcfg = _tiny(jax_v1, jax_module("models.distilbert"))(2)
    from tvts_tpu.data.image_datasets import ConceptualCaptions3M

    item = ConceptualCaptions3M("ConceptualCaptions3M", {}, small["video_params"], str(cc),
                                meta_root=str(cc), patches_per_frame=jcfg.patches_per_frame,
                                mask_ratio=0.5, per_tube_masks=jcfg.n_tubes)[0]
    assert item["keep_ind"].shape == (jcfg.n_keep,)
    video = item["video"][None]
    with pytest.raises(IndexError):
        jax_v1.TVTSv1(jcfg).init(jax.random.PRNGKey(0), video, np.ones((1, 16), np.int32),
                                 np.ones((1, 16), np.int32), item["keep_ind"][None])
    with pytest.raises(ValueError, match="per_tube_masks.*joint_vit.py:84-86"):
        cli.main(["-c", path, "--bert_vocab", vocab, "--device", "cpu"])
