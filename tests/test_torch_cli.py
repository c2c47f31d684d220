"""The port's CLI twins (tvts_torch/cli) against the JAX package's scripts/ on
the CPU: a tiny arch injected into both model registries, the same weights
in both (a reference `.pth` written from the JAX tree by
`state_dict_from_jax`), the same synthetic dataset trees and videos. The
metric lines the two print are equal; the embeddings each computed lie
within 2e-5 in float32 (PARITY.md section 2.4). The JAX scripts run their
eager towers (their fused paths have no interpret switch); the port runs
both its eager towers and, with --fused, the kernels' plain versions."""

import importlib.util
import json
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from tests.test_datasets import write_video  # noqa: E402
from tvts_torch.models import configs as port_configs  # noqa: E402
from tvts_torch.utils.convert import state_dict_from_jax  # noqa: E402

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
ATOL = RTOL = 2e-5
ARCH = "TVTSv2_TINY_CLI"
CLASSES = ["ApplyEyeMakeup", "Archery", "Basketball", "BenchPress"]


def tiny_fields():
    """The fields of the tiny config (real CLIP vocabulary and context)."""
    return dict(
        vision=dict(input_resolution=64, patch_size=16, width=64, layers=2, heads=4,
                    output_dim=48, num_frames=4, mask_ratio=0.5),
        text=dict(context_length=77, vocab_size=49408, width=64, layers=2, heads=4,
                  output_dim=48),
        sort=dict(embed_dim=48, num_heads=4, num_classes=4))


def config_of(mod):
    f = tiny_fields()
    return mod.TVTSv2Config(name="tiny_cli", vision=mod.VisionConfig(**f["vision"]),
                            text=mod.TextConfig(**f["text"]), sort=mod.SortConfig(**f["sort"]))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A reference .pth of the tiny model: the JAX initializers plus seeded
    noise on every leaf (the time attention is zero at init)."""
    from tvts_tpu.models import configs as jax_configs
    from tvts_tpu.models.factory import init_params
    from tvts_tpu.models.tvts_v2 import TVTSv2

    cfg = config_of(jax_configs)
    params = init_params(TVTSv2(cfg), cfg, seed=0)
    noise = np.random.default_rng(1)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.02 * noise.standard_normal(
        a.shape).astype(np.float32), params)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.pth")
    torch.save({k: torch.from_numpy(v) for k, v in state_dict_from_jax(params).items()}, path)
    return path


@pytest.fixture(autouse=True)
def tiny_arch(monkeypatch):
    from tvts_tpu.models import configs as jax_configs

    monkeypatch.setitem(jax_configs.MODEL_REGISTRY, ARCH, lambda: config_of(jax_configs))
    monkeypatch.setitem(port_configs.MODEL_REGISTRY, ARCH, lambda: config_of(port_configs))


def load_script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_script_{name}",
                                                  os.path.join(SCRIPTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_both(script, port_main, argv, monkeypatch, capsys, port_flags=()):
    """(JAX stdout, port stdout, port return value) of the same arguments;
    `port_flags` go to the port only."""
    monkeypatch.setattr(sys, "argv", [script, *argv])
    load_script(script).main()
    want = capsys.readouterr().out
    got_value = port_main([*argv, *port_flags, "--device", "cpu"])
    got = capsys.readouterr().out
    return want, got, got_value


def metric_lines(out: str, pattern: str) -> list[str]:
    lines = [line for line in out.splitlines() if re.match(pattern, line)]
    assert lines, out
    return lines


def capture(monkeypatch, module, name="extract_embeddings"):
    """Wrap module.<name>, recording each call's return value."""
    calls = []
    original = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append(original(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(module, name, wrapper)
    return calls


def write_config(tmp_path, name, dataset, data_dir, meta_root, **extra):
    """A zero-shot config of the repo's schema (tvts_tpu/configs/zero-*.json)
    over the tiny arch and a synthetic tree."""
    config = {
        "name": name,
        "arch": {"type": ARCH, "args": {"load_checkpoint": ""}},
        "data_loader": {"type": "ShardedLoader", "args": {
            "dataset_name": dataset, "data_dir": data_dir, "reader": "cv2",
            "patches_per_frame": 16, "mask_ratio": 0, "shuffle": False, "num_workers": 2,
            "batch_size": 3, "split": "test", "subsample": 1, "meta_root": meta_root,
            "text_params": {"input": "text"},
            "video_params": {"input_res": 64, "num_frames": 4, "loading": "strict"},
            **extra}},
        "metrics": ["t2v_metrics", "v2t_metrics"],
        "trainer": {"save_dir": str(tmp_path / "exps")},
    }
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(config))
    return str(path)


@pytest.fixture(scope="module")
def msrvtt_tree(tmp_path_factory):
    """MSRVTT's layout: 7 jsfusion val videos with 3 captions each and the
    caption index pickled as a plain dict."""
    import pickle

    root = tmp_path_factory.mktemp("msrvtt")
    data_dir, meta_root = root / "data", root / "meta"
    vids = [f"video{i}" for i in range(9)]
    for i, v in enumerate(vids):
        write_video(str(data_dir / "videos" / "all" / f"{v}.mp4"), n_frames=24 + 5 * i)
    anns = [{"image_id": v, "caption": f"{w} number {j} of {v}"} for v in vids
            for j, w in enumerate(["a dog runs", "someone cooks", "a man sings"])]
    os.makedirs(meta_root / "msrvtt")
    (meta_root / "msrvtt" / "MSR_VTT.json").write_text(json.dumps({"annotations": anns}))
    split_dir = data_dir / "high-quality" / "structured-symlinks"
    os.makedirs(split_dir)
    (split_dir / "train_list_jsfusion.txt").write_text("\n".join(vids[:2]) + "\n")
    (split_dir / "val_list_jsfusion.txt").write_text("\n".join(vids[2:]) + "\n")
    with open(split_dir / "jsfusion_val_caption_idx.pkl", "wb") as f:
        pickle.dump({v: i % 3 for i, v in enumerate(vids[2:])}, f)
    return str(data_dir), str(meta_root)


@pytest.fixture(scope="module")
def class_trees(tmp_path_factory):
    """UCF101 (prompt tsv + label2id.json) and SSV2-MC (jsonl) layouts."""
    root = tmp_path_factory.mktemp("cls")
    meta = root / "meta"
    os.makedirs(meta / "ucf101" / "prompt")
    (meta / "ucf101" / "prompt" / "label2id.json").write_text(
        json.dumps({c: i for i, c in enumerate(reversed(CLASSES))}))  # ids not in key order
    rows = []
    for k in range(7):
        rel = f"{CLASSES[k % 4]}/v_{k}.avi"
        write_video(str(root / "ucf101" / rel), n_frames=20 + 3 * k, size=80)
        rows.append(f"{rel}\t{k % 4}")
    (meta / "ucf101" / "prompt" / "testlist01_new.tsv").write_text(
        "path\tlabel\n" + "\n".join(rows) + "\n")
    os.makedirs(meta / "ssv2" / "mc")
    recs = []
    for k in range(6):
        write_video(str(root / "ssv2" / "videos" / f"{k}.webm.mp4"), n_frames=24, size=80)
        recs.append({"clip_name": f"{k}.webm.mp4", "answer": (2 * k) % 5,
                     "options": [f"a person {CLASSES[(k + o) % 4]} {o}" for o in range(5)]})
    (meta / "ssv2" / "mc" / "val.jsonl").write_text("\n".join(map(json.dumps, recs)) + "\n")
    return str(root), str(meta)


@pytest.mark.parametrize("fused,stride", [(False, -1), (True, -1), (False, 2)],
                         ids=["eager", "fused", "sliding-window"])
def test_zero_ret_cli_equals_the_jax_script(msrvtt_tree, checkpoint, tmp_path,
                                            monkeypatch, capsys, fused, stride):
    from tvts_torch.cli import zero_ret
    from tvts_torch.eval import zero_ret as port_eval
    from tvts_tpu.eval import zero_ret as jax_eval

    data_dir, meta_root = msrvtt_tree
    cfg = write_config(tmp_path, "msrvtt", "MSRVTT", data_dir, meta_root, cut="jsfusion")
    want_emb, got_emb = capture(monkeypatch, jax_eval), capture(monkeypatch, port_eval)
    argv = ["-c", cfg, "--load_checkpoint", checkpoint, "--sliding_window_stride", str(stride)]
    want, got, (metrics, sims) = run_both("zero_ret_TVTSv2", zero_ret.main, argv, monkeypatch,
                                          capsys, ["--fused"] if fused else [])
    assert metric_lines(got, r"\[(t2v|v2t)_metrics\]") == \
        metric_lines(want, r"\[(t2v|v2t)_metrics\]")
    assert set(metrics) == {"t2v_metrics", "v2t_metrics"} and np.isfinite(sims).all()
    for key in ("video", "text"):
        np.testing.assert_allclose(got_emb[-1][key], want_emb[-1][key], atol=ATOL, rtol=RTOL)
    assert [m["paths"] for m in got_emb[-1]["metas"]] == \
        [m["paths"] for m in want_emb[-1]["metas"]]


def test_zero_recognition_cli_equals_the_jax_script(class_trees, checkpoint, tmp_path,
                                                    monkeypatch, capsys):
    from tvts_torch.cli import zero_recognition
    from tvts_torch.eval import zero_recognition as port_eval
    from tvts_tpu.eval import zero_recognition as jax_eval

    root, meta = class_trees
    cfg = write_config(tmp_path, "ucf", "UCF101", os.path.join(root, "ucf101"), meta)
    want_emb, got_emb = capture(monkeypatch, jax_eval), capture(monkeypatch, port_eval)
    argv = ["-c", cfg, "--load_checkpoint", checkpoint, "--meta_root", meta]
    want, got, result = run_both("zero_recognition_TVTSv2", zero_recognition.main, argv,
                                 monkeypatch, capsys)
    assert metric_lines(got, "Top-1 accuracy") == metric_lines(want, "Top-1 accuracy")
    assert result["logits"].shape == (6, len(CLASSES))  # drop_last: 2 batches of 3
    np.testing.assert_allclose(got_emb[-1]["video"], want_emb[-1]["video"], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(got_emb[-1]["labels"], want_emb[-1]["labels"])


def test_zero_ssv2_mc_cli_equals_the_jax_script(class_trees, checkpoint, tmp_path,
                                                monkeypatch, capsys):
    from tvts_torch.cli import zero_ssv2_mc

    root, meta = class_trees
    cfg = write_config(tmp_path, "ssv2", "SSV2_mc", os.path.join(root, "ssv2"), meta)
    argv = ["-c", cfg, "--load_checkpoint", checkpoint]
    want, got, result = run_both("zero_ssv2_mc_TVTSv2", zero_ssv2_mc.main, argv, monkeypatch,
                                 capsys)
    assert metric_lines(got, "SSV2-MC accuracy") == metric_lines(want, "SSV2-MC accuracy")
    assert result["total"] == 6


@pytest.mark.parametrize("flags", [[], ["--fused"], ["--fast_pipeline"]],
                         ids=["host", "fused", "fast-pipeline"])
def test_feature_extraction_cli_equals_the_jax_script(checkpoint, tmp_path, monkeypatch,
                                                      capsys, flags):
    from tvts_torch.cli import feature_extraction

    video = str(tmp_path / "demo.mp4")
    write_video(video, n_frames=33, size=96)
    want_path, got_path = str(tmp_path / "want.npy"), str(tmp_path / "got.npy")
    common = ["--arch", ARCH, "--video_path", video, "--load_checkpoint", checkpoint]
    jax_flags = [f for f in flags if f != "--fused"]  # the JAX fused path needs the TPU
    monkeypatch.setattr(sys, "argv", ["fe", *common, *jax_flags, "--out", want_path])
    load_script("feature_extraction_TVTSv2").main()
    want = capsys.readouterr().out
    emb = feature_extraction.main([*common, *flags, "--out", got_path, "--device", "cpu"])
    got = capsys.readouterr().out
    assert metric_lines(got, "video embedding shape") == \
        metric_lines(want, "video embedding shape") == ["video embedding shape: (1, 48)"]
    np.testing.assert_array_equal(np.load(got_path), emb)
    np.testing.assert_allclose(emb, np.load(want_path), atol=ATOL, rtol=RTOL)


def test_cli_refuses_cuda_without_a_card(checkpoint, tmp_path):
    from tvts_torch.cli import feature_extraction

    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    video = str(tmp_path / "demo.mp4")
    write_video(video, n_frames=12, size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        feature_extraction.main(["--arch", ARCH, "--video_path", video])


@pytest.mark.parametrize("arch", ["B_16", "B_32", "H_14"])
def test_aliases_pin_the_arch_and_delegate(monkeypatch, arch):
    import importlib

    from tvts_torch.cli import feature_extraction, zero_recognition, zero_ret, zero_ssv2_mc

    seen = []
    monkeypatch.setattr(feature_extraction, "main", lambda argv: seen.append(argv))
    importlib.import_module(f"tvts_torch.cli.feature_extraction_{arch}").main(
        ["--video_path", "x.mp4"])
    assert seen == [["--arch", f"TVTSv2_{arch}", "--video_path", "x.mp4"]]
    for cli in (zero_ret, zero_recognition, zero_ssv2_mc):
        alias = importlib.import_module(f"{cli.__name__}_ViT_{arch}")
        assert alias.main is cli.main  # the config names the arch, as in scripts/
