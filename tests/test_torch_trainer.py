"""The port's Trainer and train CLI on the CPU against the JAX package's.

A tiny cv2-written pretraining layout (chip_smoke.pretrain_trees: YT-Temporal
and WebVid, with val splits) under the repo's pretraining config at a tiny
arch injected into both model registries, the same seeded weights in both (a
reference `.pth`), `num_workers=0`, `random.seed` before each run (the
datasets draw from `random`), float32:
- scripts/train_dist_TVTSv2.py and tvts_torch/cli/train_dist_TVTSv2.py on
  the same file: every step's `loss_train_{i}` within 2e-5, and the
  validation logs (init and per epoch) equal; the port also on the kernel
  path (`trainer.kernels`, the kernels' plain versions here) against the
  same JAX run;
- resume: 1 epoch + save + `-r` + 1 epoch is bit for bit 2 straight epochs
  (parameters, optimizer state, step count); an epoch checkpoint loads
  through strict `build_model`;
- the epoch loop's bookkeeping (buffered aux, writer steps, step
  checkpoints, the profile window) with a stand-in step.
"""

import json
import os
import random
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from tests.test_torch_cli import load_script  # noqa: E402
from tvts_torch.models import configs as port_configs  # noqa: E402

ARCH = "TVTSv2_TINY_TRAIN"
LOSS_ATOL = 2e-5
B = 4


def tiny_config(mod):
    """The pretraining config's shapes at a tiny width: 12 frames (YT-Temporal
    3 x 4 clips, WebVid 12), 4 patches a frame, mask 0.5."""
    return mod.TVTSv2Config(
        name="tiny_train", vision=mod.VisionConfig(
            input_resolution=32, patch_size=16, width=64, layers=2, heads=4, output_dim=48,
            num_frames=12, mask_ratio=0.5, pool_style="openai", act="quick_gelu"),
        text=mod.TextConfig(context_length=77, vocab_size=49408, width=64, layers=2, heads=4,
                            output_dim=48),
        sort=mod.SortConfig(embed_dim=48, num_heads=4, num_classes=4))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny shapes gain nothing from more, and
    several test workers run at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def registries():
    """The tiny arch in both model registries for the module's runs."""
    from tvts_tpu.models import configs as jax_configs

    mp = pytest.MonkeyPatch()
    mp.setitem(jax_configs.MODEL_REGISTRY, ARCH, lambda: tiny_config(jax_configs))
    mp.setitem(port_configs.MODEL_REGISTRY, ARCH, lambda: tiny_config(port_configs))
    yield
    mp.undo()


def pretrain_tree(root, batch_size, n_ytt=16, n_webvid=8, val=8):
    """(config dict, its loaders over a tiny YT-Temporal + WebVid layout with
    val splits of `val` videos each)."""
    path, specs = chip_smoke.pretrain_trees(
        str(root), {"num_workers": 0, "batch_size": batch_size, "reader": "cv2",
                    "patches_per_frame": 4}, {"input_res": 32},
        ytt=(n_ytt, 30, 2, (48, 64)), webvid=(n_webvid, 4, 4, (48, 64)), val=val, words_s=0.5)
    chip_smoke.write_clips(specs, 4)
    with open(path) as f:
        return json.load(f)


def seeded_checkpoint(path, seed=3, arch=ARCH):
    """A reference .pth of `arch`: the port's initial weights plus seeded
    noise on every leaf (the time attention is zero at init)."""
    from tvts_torch.models.factory import build_model

    _, model = build_model(arch, eval_mode=False, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(seed)
    sd = {k: v + 0.02 * torch.randn(v.shape, generator=gen) for k, v in model.state_dict().items()}
    torch.save(sd, path)
    return str(path)


def write_config(base, path, save_dir, loaders=2, **trainer):
    """The pretraining config over the tiny tree with `trainer` keys; its
    first `loaders` data loaders (YT-Temporal, WebVid)."""
    config = json.loads(json.dumps(base))
    config["data_loader"] = config["data_loader"][:loaders]
    config["arch"] = {"type": ARCH, "args": {"load_checkpoint": trainer.pop("checkpoint")}}
    config["trainer"] = {"epochs": 2, "save_dir": str(save_dir), "save_period": 1,
                         "monitor": "min val_loss_0", "init_val": True, **trainer}
    with open(path, "w") as f:
        json.dump(config, f)
    return str(path)


class Recorder:
    """Wraps Trainer methods and ScalarWriter.__call__ of one package: each
    epoch's train and validation logs, the scalars written."""

    def __init__(self, mp, trainer_cls, writer_cls):
        self.train, self.val, self.scalars = [], [], []
        for name, out in (("_train_epoch", self.train), ("_valid_epoch", self.val)):
            original = getattr(trainer_cls, name)

            def wrapped(trainer, epoch, _original=original, _out=out):
                log = _original(trainer, epoch)
                _out.append((epoch, dict(log)))
                return log

            mp.setattr(trainer_cls, name, wrapped)
        original_call = writer_cls.__call__

        def call(writer, tag, value, step):
            self.scalars.append((tag, float(value), int(step)))
            return original_call(writer, tag, value, step)

        mp.setattr(writer_cls, "__call__", call)

    def losses(self):
        return [(tag, step, v) for tag, v, step in self.scalars if tag.startswith("loss_train")]


def fast_jax_init(mp):
    """The JAX package builds its initial weights op by op (~40 s for the tiny
    arch on a CPU); the checkpoint sets every one of them, so the runs
    here start from zeros of their shapes instead."""
    import jax

    from tvts_tpu.models import factory

    original = factory.init_params

    def zeros(model, cfg, seed=0):
        shapes = jax.eval_shape(lambda: original(model, cfg, seed))
        return jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)

    mp.setattr(factory, "init_params", zeros)


def record_run(trainer_cls, writer_cls, run):
    """run() under a Recorder of one package's Trainer and ScalarWriter."""
    mp = pytest.MonkeyPatch()
    try:
        rec = Recorder(mp, trainer_cls, writer_cls)
        random.seed(1234)
        rec.result = run()
    finally:
        mp.undo()
    return rec


def one_device_mesh(mp):
    """The JAX script's mesh over one CPU device: its step is the same
    function on any mesh, and it compiles several times faster unsharded."""
    import jax

    import tvts_tpu.parallel as parallel

    original = parallel.create_mesh
    mp.setattr(parallel, "create_mesh",
               lambda **kw: original(devices=jax.devices()[:1], **kw))


@pytest.fixture(scope="module")
def runs(registries, tmp_path_factory):
    """The JAX script and the port's CLI (eager, and on the kernel path) on
    the same config, each from random.seed(1234)."""
    from tvts_tpu.train import trainer as jax_trainer
    from tvts_tpu.utils import logging as jax_logging
    from tvts_torch.cli import train_dist_TVTSv2 as cli
    from tvts_torch.train import trainer as port_trainer
    from tvts_torch.utils import logging as port_logging

    root = tmp_path_factory.mktemp("trainer_runs")
    base = pretrain_tree(root / "data", B, n_ytt=3 * B, n_webvid=B, val=2 * B)
    ckpt = seeded_checkpoint(root / "init.pth")
    eager = write_config(base, root / "eager.json", root / "jax", loaders=1, checkpoint=ckpt)
    mp = pytest.MonkeyPatch()
    try:
        fast_jax_init(mp)
        one_device_mesh(mp)
        mp.setattr(sys, "argv", ["train", "-c", eager, "--no-bf16"])
        out = {"jax": record_run(jax_trainer.Trainer, jax_logging.ScalarWriter,
                                 load_script("train_dist_TVTSv2").main)}
    finally:
        mp.undo()
    eager = write_config(base, root / "eager_port.json", root / "port", loaders=1,
                         checkpoint=ckpt)
    fused = write_config(base, root / "fused.json", root / "fused", loaders=1, checkpoint=ckpt,
                         kernels={"fused": True, "preset": "best"})
    for name, path in (("port", eager), ("kernels", fused)):
        out[name] = record_run(port_trainer.Trainer, port_logging.ScalarWriter,
                               lambda: cli.main(["-c", path, "--no-bf16", "--device", "cpu"]))
    out["trainer"] = out["port"].result
    return out


@pytest.mark.parametrize("path", ["port", "kernels"])
def test_trainer_steps_and_validation_match_jax(runs, path):
    want, got = runs["jax"], runs[path]
    # 2 epochs x 3 YT-Temporal batches
    assert [(t, s) for t, s, _ in got.losses()] == [(t, s) for t, s, _ in want.losses()] == \
        [("loss_train_0", k + 1) for k in range(6)]
    np.testing.assert_allclose([v for *_, v in got.losses()], [v for *_, v in want.losses()],
                               atol=LOSS_ATOL, rtol=0)
    assert [e for e, _ in got.val] == [e for e, _ in want.val] == [0, 1, 2]
    for (_, g), (_, w) in zip(got.val, want.val):
        assert sorted(g) == sorted(w) and "val_0_sort_acc" in g
        for key in w:
            assert g[key] == pytest.approx(w[key], abs=1e-6), key
    assert [k for k, _, _ in got.scalars if not k.startswith("loss")] == \
        [k for k, _, _ in want.scalars if not k.startswith("loss")]


def test_cli_epoch_loss_matches_the_jax_script(runs):
    want, got = runs["jax"].train, runs["port"].train
    assert [e for e, _ in got] == [e for e, _ in want] == [1, 2]
    for (_, g), (_, w) in zip(got, want):
        assert sorted(g) == sorted(w) == ["loss_0"]
        for key in w:
            np.testing.assert_allclose(g[key], w[key], atol=LOSS_ATOL, rtol=0, err_msg=key)


def test_epoch_checkpoint_layout_and_strict_load(runs):
    from tvts_torch.models.factory import build_model
    from tvts_torch.utils.convert import load_reference_state_dict

    trainer = runs["trainer"]
    save_dir = trainer.ckpt.save_dir
    files = sorted(os.listdir(save_dir))
    assert {"checkpoint-epoch1.pth", "checkpoint-epoch2.pth", "model_best.pth"} <= set(files)
    assert trainer.ckpt.latest_epoch() == 2
    ckpt = trainer.ckpt.restore("checkpoint-epoch2")
    assert sorted(ckpt) == ["arch", "config", "epoch", "monitor_best", "optimizer", "state_dict",
                            "step"]
    assert (ckpt["arch"], ckpt["epoch"], ckpt["step"]) == (ARCH, 2, trainer.train_step.count) \
        == (ARCH, 2, 6)
    assert ckpt["monitor_best"] == trainer.ckpt.monitor.best
    assert all(k.startswith("module.") for k in ckpt["state_dict"])
    assert ckpt["config"]["arch"]["type"] == ARCH
    _, model = build_model(ARCH, load_checkpoint=os.path.join(save_dir, "checkpoint-epoch2.pth"),
                           eval_mode=False, device="cpu")
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key
    assert set(load_reference_state_dict(trainer.ckpt.path("model_best"))) == \
        set(trainer.model.state_dict())


def _state(trainer):
    opt = trainer.optimizer.state_dict()
    return trainer.model.state_dict(), opt["state"], trainer.train_step.count


def test_resume_is_bit_for_bit(registries, tmp_path):
    from tvts_torch.cli import train_dist_TVTSv2 as cli

    # both loaders: the WebVid one (3 batches) restarts in every epoch of 4 YT-Temporal steps
    base = pretrain_tree(tmp_path / "data", 2, n_ytt=8, n_webvid=6, val=2)
    ckpt = seeded_checkpoint(tmp_path / "init.pth")
    straight = write_config(base, tmp_path / "straight.json", tmp_path / "straight",
                            checkpoint=ckpt)
    random.seed(7)
    want = _state(cli.main(["-c", straight, "--no-bf16", "--device", "cpu"]))
    first = write_config(base, tmp_path / "first.json", tmp_path / "first", checkpoint=ckpt,
                         epochs=1)
    random.seed(7)
    one = cli.main(["-c", first, "--no-bf16", "--device", "cpu"])
    path = one.ckpt.path("checkpoint-epoch1")
    second = write_config(base, tmp_path / "second.json", tmp_path / "second", checkpoint=ckpt)
    got = _state(cli.main(["-c", second, "--no-bf16", "--device", "cpu", "-r", path]))
    assert got[2] == want[2] == 16
    for key, value in want[0].items():
        assert torch.equal(got[0][key], value), key
    assert sorted(got[1]) == sorted(want[1])
    for i, state in want[1].items():
        for key, value in state.items():
            assert torch.equal(torch.as_tensor(got[1][i][key]), torch.as_tensor(value)), (i, key)


# ---------------------------------------------------------------------------
# the epoch loop with a stand-in step
# ---------------------------------------------------------------------------
class FakeLoader:
    def __init__(self, n, batch_size=2):
        self.n, self.batch_size, self.num_processes = n, batch_size, 1

        class _DS:
            dataset_name = "YTTemporal"

        self.dataset = _DS()

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        for _ in range(self.n):
            yield {"video": np.zeros((self.batch_size, 1, 3, 4, 4), np.float32),
                   "keep_ind": np.zeros((self.batch_size, 1), np.int32),
                   "text": ["a"] * self.batch_size}


class FakeStep:
    """Counts steps; step k's loss is k (after the step)."""

    def __init__(self, count=0):
        self.count, self.losses = count, []

    def __call__(self, batch):
        self.count += 1
        self.losses.append(float(self.count))
        v = torch.tensor(float(self.count))
        return {"loss": v, "loss_ct": v / 2, "loss_ce": v / 2, "sort_acc": torch.zeros(())}


class RecordingCkpt:
    def __init__(self):
        self.step_saves = []

    def save_step(self, step, state, epoch=0):
        self.step_saves.append((step, state["step"], epoch))


def bare_trainer(n_steps, log_step, save_every_steps=None, start_step=0, **kw):
    from tvts_torch.train.optim import OptimizerConfig
    from tvts_torch.train.trainer import Trainer

    model = torch.nn.Linear(1, 1)
    t = Trainer(model, torch.optim.SGD(model.parameters(), lr=0.0), OptimizerConfig(),
                [FakeLoader(n_steps)],
                log_step=log_step, save_every_steps=save_every_steps, context_length=16,
                tokenize_fn=lambda texts: {"text_ids": np.zeros((len(texts), 4), np.int32)},
                ckpt_manager=RecordingCkpt() if save_every_steps else None, **kw)
    t.train_step = FakeStep(start_step)
    return t


@pytest.mark.parametrize("log_step", [1, 3, 100])  # flush a step / mid-epoch / at the end only
def test_buffered_totals_match_per_step_mean(log_step):
    t = bare_trainer(7, log_step)
    log = t._train_epoch(1)
    assert len(t.train_step.losses) == 7
    np.testing.assert_allclose(log["loss_0"], np.mean(t.train_step.losses), rtol=1e-6)


def test_writer_steps_without_a_host_sync_a_step():
    rows = []
    t = bare_trainer(5, log_step=2, start_step=10)
    t.writer = lambda key, val, step: rows.append((key, val, step))
    t._train_epoch(1)
    assert rows == [("loss_train_0", float(s), s) for s in range(11, 16)]


def test_save_every_steps_uses_the_step_count():
    t = bare_trainer(6, log_step=100, save_every_steps=2)
    t._train_epoch(3)
    assert t.ckpt.step_saves == [(2, 2, 2), (4, 4, 2), (6, 6, 2)]


def test_profile_window_closes_on_a_short_epoch(tmp_path):
    from tvts_torch.utils.profiling import trace_artifacts

    t = bare_trainer(2, log_step=10, profile_dir=str(tmp_path / "tb"), profile_steps=(0, 100))
    t._train_epoch(1)
    assert len(trace_artifacts(str(tmp_path / "tb"))) == 1


def test_train_cli_refuses_what_it_cannot_run(tmp_path):
    from tvts_torch.cli import train_dist_TVTSv2 as cli
    from tvts_torch.parallel.mesh import create_mesh

    config = str(tmp_path / "c.json")
    with open(config, "w") as f:
        json.dump({"arch": {"type": "TVTSv2_B_16", "args": {}}}, f)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["-c", config])
    # --fsdp 2 shards over groups of 2 ranks: one process has none
    with pytest.raises(ValueError, match="does not divide"):
        cli.main(["-c", config, "--device", "cpu", "--fsdp", "2"])
    # --tp 2 splits the heads over groups of 2 ranks: one process has none
    with pytest.raises(ValueError, match="does not divide"):
        cli.main(["-c", config, "--device", "cpu", "--tp", "2"])
    with pytest.raises(ValueError, match="does not divide"):  # sp 2 needs two ranks
        create_mesh(sp=2, device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        create_mesh(coordinator="localhost:1", device="cpu")
    mesh = create_mesh(device="cpu")
    assert (mesh.rank, mesh.world, mesh.distributed) == (0, 1, False)


@pytest.mark.parametrize("arch", ["B_16", "B_32", "H_14"])
def test_train_aliases_delegate(arch):
    import importlib

    from tvts_torch.cli import train_dist_TVTSv2 as cli

    alias = importlib.import_module(f"tvts_torch.cli.train_dist_TVTSv2_ViT_{arch}")
    assert alias.main is cli.main  # the config names the arch, as in scripts/
