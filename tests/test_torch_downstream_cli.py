"""tvts_torch/cli/run_class_finetuning.py (and its run_class_linear /
run_class_zero aliases) against scripts/run_class_finetuning.py in its three
modes, on a tiny cv2-written SSV2-shaped tree (chip_smoke.ssv2_tree) with
tests/test_cli_downstream_smoke.py's tiny arch in both, f32 in both (the JAX
script's --bf16 cannot be turned off: its models are built in f32 here; the
port gets --no-bf16 --device cpu), the same seeded v1 .pth as --finetune,
the JAX init's head in both, items read through the cv2 backend, both
loaders with num_workers=0 (items draw random.getrandbits in order), Mixup
seeded alike and `random.seed` before each run:
- finetune (mixup, --model_ema) and linear: every step's loss within 2e-5
  (the JAX step wrapped to record them, as tests/test_torch_v1_train.py
  does), each epoch's val top-1 and the multi-view test's top-1 / top-5
  equal; linear leaves every backbone tensor bit for bit;
- zero: R@1/5/10 equal.
One thread."""

import os
import random
import re
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from tests.test_torch_cli import load_script  # noqa: E402
from tvts_torch.cli import run_class_finetuning as cli  # noqa: E402
from tvts_torch.downstream import model as port_model  # noqa: E402
from tvts_torch.models.joint_vit import JointViT  # noqa: E402
from tvts_torch.utils import convert as port_convert  # noqa: E402

LOSS_ATOL = 2e-5
TINY = ["--embed_dim", "64", "--depth", "2", "--heads", "4", "--patch_size", "16",
        "--input_size", "64", "--short_side_size", "64", "--num_frames", "4",
        "--nb_classes", "3", "--batch_size", "4", "--epochs", "2", "--warmup_epochs", "1"]
SPLITS = {"train": 8, "val": 6, "test": 2}  # 2 steps an epoch; 2 x 6 test views


def jax_module(name):
    import importlib

    return importlib.import_module(f"tvts_tpu.{name}")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """(data root, a seeded v1 .pth of the tiny tower)."""
    root = str(tmp_path_factory.mktemp("ssv2_cli"))
    chip_smoke.ssv2_tree(root, SPLITS, clip=(21, 12, (48, 80)), classes=3, workers=4)
    tower = JointViT(img_size=64, patch_size=16, embed_dim=64, depth=2, heads=4, num_frames=4)
    tower.reset_parameters(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    path = os.path.join(root, "v1.pth")
    torch.save({"state_dict": {f"module.video_model.{k}": v + 0.02 * torch.randn(
        v.shape, generator=gen) for k, v in tower.state_dict().items()}}, path)
    return root, path


def _jax_init_head():
    """The JAX script's FinetuneViT init (PRNGKey(0) on a zero clip) as the
    port's state dict."""
    import jax

    jm = jax_module("downstream.model").FinetuneViT(num_classes=3, img_size=64, patch_size=16,
                                                    embed_dim=64, depth=2, heads=4,
                                                    num_frames=4)
    params = jm.init(jax.random.PRNGKey(0), np.zeros((1, 4, 3, 64, 64), np.float32))["params"]
    return {k: torch.tensor(v) for k, v in
            port_convert.finetune_state_dict_from_jax(jax.tree.map(np.asarray, params)).items()}


def _forced(loader_mod, ds_mod, mixup_mod) -> dict:
    """num_workers=0 loaders, cv2-read datasets, Mixup seeded with 7: the
    classes, by the name each module gives them."""
    loader, ds, mixup = loader_mod.ShardedLoader, ds_mod.VideoClsDataset, mixup_mod.Mixup

    class Loader(loader):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "num_workers": 0})

    class Dataset(ds):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "reader": "cv2"})

    class SeededMixup(mixup):
        def __init__(self, *a, **kw):
            super().__init__(*a, **{**kw, "rng": np.random.default_rng(7)})

    return {"ShardedLoader": Loader, "VideoClsDataset": Dataset, "Mixup": SeededMixup}


def run_jax(mode, argv, capsys):
    """(stdout, recorded losses) of scripts/run_class_finetuning.py in f32."""
    import jax.numpy as jnp

    dm, jv, engine = (jax_module(n) for n in ("downstream.model", "models.joint_vit",
                                              "downstream.engine"))
    losses = []
    mp = pytest.MonkeyPatch()
    try:
        mods = [jax_module(n) for n in ("data.loader", "downstream.cls_dataset",
                                         "downstream.mixup")]
        for mod, (name, cls) in zip(mods, _forced(*mods).items()):
            mp.setattr(mod, name, cls)
        for mod, name in ((dm, "FinetuneViT"), (jv, "JointViT")):
            cls = getattr(mod, name)
            mp.setattr(mod, name, lambda *a, _c=cls, **kw: _c(*a, **{**kw, "dtype": jnp.float32}))
        step_factory = engine.make_cls_train_step

        def recorded(*a, **kw):
            step = step_factory(*a, **kw)

            def run(*b):
                state, loss = step(*b)
                losses.append(float(loss))
                return state, loss

            return run

        mp.setattr(engine, "make_cls_train_step", recorded)
        mp.setattr(sys, "argv", ["run_class_finetuning", "--mode", mode, *argv])
        random.seed(1234)
        capsys.readouterr()
        load_script("run_class_finetuning").main()
        return capsys.readouterr().out, losses
    finally:
        mp.undo()


def run_port(mode, argv, head, capsys):
    from tvts_torch.cli import run_class_linear, run_class_zero

    mp = pytest.MonkeyPatch()
    try:
        from tvts_torch.data import loader
        from tvts_torch.downstream import cls_dataset, mixup

        for name, cls in _forced(loader, cls_dataset, mixup).items():
            mp.setattr(cli, name, cls)
        mp.setattr(port_model.FinetuneViT, "reset_parameters",
                   lambda self, gen: self.load_state_dict(head, strict=True))
        random.seed(1234)
        capsys.readouterr()
        flags = [*argv, "--no-bf16", "--device", "cpu"]
        if mode == "finetune":
            out = cli.main(["--mode", mode, *flags])
        else:  # through the alias, which adds --mode
            out = {"linear": run_class_linear, "zero": run_class_zero}[mode].main(flags)
        return capsys.readouterr().out, out
    finally:
        mp.undo()


def _floats(pattern, text):
    return [float(x) for m in re.findall(pattern, text)
            for x in (m if isinstance(m, tuple) else (m,))]


@pytest.mark.parametrize("mode", ["finetune", "linear", "zero"])
def test_cli_twin_matches_jax_script(tree, tmp_path, mode, capsys):
    root, ckpt = tree
    argv = ["--data_path", root, "--data_root", root, "--finetune", ckpt, *TINY]
    if mode == "finetune":
        argv.append("--model_ema")
    want_out, want_losses = run_jax(mode, argv + ["--output_dir", str(tmp_path / "jax")], capsys)
    head = _jax_init_head()
    got_out, got = run_port(mode, argv + ["--output_dir", str(tmp_path / "port")], head, capsys)
    if mode == "zero":
        want = dict(zip(("R1", "R5", "R10"), _floats(r"R@\d+: ([\d.]+)", want_out)))
        assert got["metrics"] == pytest.approx(want, abs=1e-9) and len(want) == 3
        assert got["feats"].shape == (SPLITS["val"], 64)
        return
    n_steps = 2 * SPLITS["train"] // 4
    assert len(got["losses"]) == len(want_losses) == n_steps
    assert got["losses"] == pytest.approx(want_losses, abs=LOSS_ATOL)
    assert all(np.isfinite(got["losses"]))
    want_val = _floats(r"val top1 ([\d.]+)%", want_out)
    assert [round(100 * v, 2) for v in got["val_top1"]] == want_val and len(want_val) == 2
    want_test = _floats(r"top1 ([\d.]+)% top5 ([\d.]+)% over", want_out)
    res, acc = got["test"]
    assert [round(100 * res["top1"], 2), round(100 * res["top5"], 2)] == want_test
    assert res["n"] == SPLITS["test"] and acc.count.tolist() == [6] * SPLITS["test"]
    assert got_out.splitlines()[-1] == want_out.splitlines()[-1]
    model = got["model"]
    assert os.path.isfile(os.path.join(str(tmp_path / "port"), "model_best.pth"))
    if mode == "linear":  # the backbone bit for bit the checkpoint's and init's
        init = port_model.FinetuneViT(num_classes=3, img_size=64, embed_dim=64, depth=2,
                                      heads=4, num_frames=4)
        init.load_state_dict(head)
        port_model.load_pretrain_video_tower(init, port_convert.load_reference_state_dict(ckpt))
        for name, value in model.state_dict().items():
            moved = not torch.equal(value, init.state_dict()[name])
            assert moved == name.startswith(("head.", "fc_norm.")), name
    else:
        assert got["ema"] is not None
