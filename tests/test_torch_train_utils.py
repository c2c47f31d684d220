"""The Trainer's utilities on the CPU against the JAX package: the metrics
(`acc`, `topk_acc`, `video_precision[_adj]` on tests/test_metrics.py's
cases), the CLIP init (`convert_clip_full` + `merge_params` /
`build_model(strict=False)`: key for key and value for value the JAX
package's `convert_clip_full` + `merge_params` -> `export_state_dict`, with
the same missing and unused keys), TensorBoard event files (byte for byte
under the same wall times), the `ScalarWriter` JSONL, `SmoothedValue` /
`MetricLogger`, `RetrievalVis`, `Monitor`, and the profiling helpers."""

import json
import os
import time

import numpy as np
import pytest
import torch

from tests.test_torch_cli import ARCH, config_of, tiny_arch  # noqa: F401
from tvts_torch.models import configs as port_configs
from tvts_torch.models.factory import build_model
from tvts_torch.ops import metrics as port_metrics
from tvts_torch.utils import convert, logging as port_logging, tb_events
from tvts_torch.utils.checkpoint import Monitor
from tvts_torch.utils.visualizer import RetrievalVis


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
def test_acc_and_topk_equal_jax():
    from tvts_tpu.ops import metrics as jax_metrics

    out = np.array([[0.9, 0.1, 0.0], [0.2, 0.5, 0.3], [0.1, 0.2, 0.7]])
    tgt = np.array([0, 2, 2])
    assert port_metrics.acc(out, tgt) == jax_metrics.acc(out, tgt) == pytest.approx(2 / 3)
    for k in (1, 2, 3):
        assert port_metrics.topk_acc(out, tgt, k=k) == jax_metrics.topk_acc(out, tgt, k=k)
    ties = np.array([[0.5, 0.5, 0.1], [0.3, 0.3, 0.3]])
    assert port_metrics.topk_acc(ties, np.array([1, 2]), k=1) == \
        jax_metrics.topk_acc(ties, np.array([1, 2]), k=1)
    with pytest.raises(ValueError):
        port_metrics.acc(out, tgt[:2])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_video_precision_equals_jax(seed):
    from tvts_tpu.ops import metrics as jax_metrics

    rng = np.random.default_rng(seed)
    output = rng.integers(0, 8, size=(4, 6, 2))
    target = rng.integers(0, 8, size=(4, 6, 2))
    for name in ("video_precision", "video_precision_adj"):
        assert getattr(port_metrics, name)(output, target) == \
            getattr(jax_metrics, name)(output, target)
    assert port_metrics._pair_matches(output, target) == jax_metrics._pair_matches(output, target)


# ---------------------------------------------------------------------------
# CLIP init
# ---------------------------------------------------------------------------
def _clip_block(prefix, width, rng):
    shapes = {"ln_1.weight": (width,), "ln_1.bias": (width,),
              "attn.in_proj_weight": (3 * width, width), "attn.in_proj_bias": (3 * width,),
              "attn.out_proj.weight": (width, width), "attn.out_proj.bias": (width,),
              "ln_2.weight": (width,), "ln_2.bias": (width,),
              "mlp.c_fc.weight": (4 * width, width), "mlp.c_fc.bias": (4 * width,),
              "mlp.c_proj.weight": (width, 4 * width), "mlp.c_proj.bias": (width,)}
    return {f"{prefix}.{k}": rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}


def clip_state_dict(seed=0):
    """An OpenAI-CLIP state dict of the tiny arch's widths from seeded numpy,
    with a third block in each tower (unused: the tiny arch has two) and
    logit_scale (dropped)."""
    f = config_of(port_configs)
    v, t = f.vision, f.text
    rng = np.random.default_rng(seed)
    n = (v.input_resolution // v.patch_size) ** 2
    sd = {"visual.class_embedding": (v.width,), "visual.positional_embedding": (n + 1, v.width),
          "visual.proj": (v.width, v.output_dim),
          "visual.conv1.weight": (v.width, 3, v.patch_size, v.patch_size),
          "visual.ln_pre.weight": (v.width,), "visual.ln_pre.bias": (v.width,),
          "visual.ln_post.weight": (v.width,), "visual.ln_post.bias": (v.width,),
          "token_embedding.weight": (t.vocab_size, t.width),
          "positional_embedding": (t.context_length, t.width),
          "ln_final.weight": (t.width,), "ln_final.bias": (t.width,),
          "text_projection": (t.width, t.output_dim), "logit_scale": ()}
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in sd.items()}
    for i in range(3):
        sd.update(_clip_block(f"visual.transformer.resblocks.{i}", v.width, rng))
        sd.update(_clip_block(f"transformer.resblocks.{i}", t.width, rng))
    return sd


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_clip_init():
    """(the port's initial weights, the JAX package's CLIP merge onto the same
    weights (converted into its tree) exported, the reference names of its
    unused entries)."""
    from tvts_tpu.utils.torch_convert import (
        convert_clip_full, convert_state_dict, export_state_dict, merge_params)

    _, model = build_model(ARCH, eval_mode=False, device="cpu", seed=0)
    init_sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params = convert_state_dict(init_sd)
    loaded = convert_clip_full(clip_state_dict())
    merged = export_state_dict(merge_params(params, loaded, strict=False), ddp_prefix=False)
    init = dict(_flatten(params))
    unused_tree: dict = {}
    for path, arr in _flatten(loaded):
        if path not in init:
            node = unused_tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = arr
    return init_sd, merged, set(convert.state_dict_from_jax(unused_tree))


def _save(sd, path):
    torch.save({k: torch.as_tensor(np.array(v)) for k, v in sd.items()}, path)
    return str(path)


def test_clip_init_equals_jax_key_for_key(tmp_path):
    init_sd, want, jax_unused = jax_clip_init()
    _, model = build_model(ARCH, load_checkpoint=_save(init_sd, tmp_path / "init.pth"),
                           eval_mode=False, device="cpu")
    clip = {k: torch.from_numpy(v) for k, v in clip_state_dict().items()}
    missing, unused = convert.merge_params(model, convert.convert_clip_full(clip))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    assert set(unused) == jax_unused  # both towers' third block: the tiny arch has two
    assert len(unused) == 24 and all(".resblocks.2." in k for k in unused)
    new = {k for k in got if ".timeattn." in k or ".ln_3." in k or k.startswith("pred_model.")}
    assert set(missing) == new | {"video_model.temporal_embedding"}
    np.testing.assert_array_equal(got["video_model.transformer.resblocks.0.attn.qkv.weight"],
                                  clip["visual.transformer.resblocks.0.attn.in_proj_weight"])


def test_build_model_non_strict_overlays_the_clip_weights(tmp_path):
    clip = {k: torch.from_numpy(v) for k, v in clip_state_dict().items()}
    converted = convert.convert_clip_full(clip)
    path = _save(converted, tmp_path / "clip.pth")
    _, fresh = build_model(ARCH, eval_mode=False, device="cpu", seed=0)
    _, model = build_model(ARCH, load_checkpoint=path, eval_mode=False, device="cpu",
                           strict=False)
    fresh, got = fresh.state_dict(), model.state_dict()
    for key, value in got.items():
        np.testing.assert_array_equal(value, converted.get(key, fresh[key]), err_msg=key)
    with pytest.raises(RuntimeError, match="Missing key"):
        build_model(ARCH, load_checkpoint=path, eval_mode=False, device="cpu")
    bad = dict(converted, **{"video_model.proj": torch.zeros(3, 3)})
    with pytest.raises(ValueError, match="shape mismatch at video_model.proj"):
        build_model(ARCH, load_checkpoint=_save(bad, tmp_path / "bad.pth"), eval_mode=False,
                    device="cpu", strict=False)
    with pytest.raises(ValueError, match="unused loaded params"):
        convert.merge_params(model, converted, strict=True)


# ---------------------------------------------------------------------------
# logging, TensorBoard events, pages, monitor
# ---------------------------------------------------------------------------
@pytest.fixture
def clock(monkeypatch):
    """time.time as a counter from a fixed start; `reset()` restarts it."""
    state = {"t": 0}

    def fake():
        state["t"] += 1
        return 1_700_000_000.25 + 0.5 * state["t"]

    monkeypatch.setattr(time, "time", fake)
    return lambda: state.update(t=0)


SCALARS = [("loss_train_0", 1.5, 10), ("val_loss_0", 0.25, 10), ("loss_train_0", 1.25, 20),
           ("val_0_t2v_metrics_R1", 37.5, 20), ("loss_train_1", float("inf"), 21)]


def test_tb_event_file_is_byte_for_byte_jax(clock, tmp_path):
    from tvts_tpu.utils import tb_events as jax_tb

    paths = []
    for mod, sub in ((jax_tb, "jax"), (tb_events, "port")):
        clock()
        w = mod.EventWriter(str(tmp_path / sub))
        for tag, value, step in SCALARS:
            w.add_scalar(tag, value, step)
        w.close()
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    want, got = (open(p, "rb").read() for p in paths)
    assert got == want
    assert tb_events.read_events(paths[1]) == jax_tb.read_events(paths[0]) == \
        [(step, tag, value) for tag, value, step in SCALARS]
    assert tb_events.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


@pytest.mark.parametrize("tensorboard", [False, True])
def test_scalar_writer_equals_jax(clock, tmp_path, tensorboard):
    from tvts_tpu.utils import logging as jax_logging

    out = {}
    for mod, sub in ((jax_logging, "jax"), (port_logging, "port")):
        clock()
        w = mod.ScalarWriter(str(tmp_path / sub), flush_every=2, tensorboard=tensorboard)
        for tag, value, step in SCALARS[:4]:
            w(tag, value, step)
        w.close()
        out[sub] = sorted(os.listdir(tmp_path / sub))
        text = (tmp_path / sub / "scalars.jsonl").read_text()
        out[sub + "_jsonl"] = text
    assert out["port_jsonl"] == out["jax_jsonl"]
    tags = [json.loads(line)["tag"] for line in out["port_jsonl"].splitlines()]
    assert tags.count("steps_per_sec") == 2 and tags.count("loss_train_0") == 2
    assert out["port"] == out["jax"]
    if tensorboard:
        name = [f for f in out["port"] if f.startswith("events.out.tfevents.")][0]
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_smoothed_value_and_metric_logger_equal_jax(clock, capsys):
    from tvts_tpu.utils import logging as jax_logging

    outs = []
    for mod in (jax_logging, port_logging):
        clock()
        sv = mod.SmoothedValue(window_size=3)
        for v in (1.0, 2.0, 3.0, 4.0):
            sv.update(v, n=2)
        ml = mod.MetricLogger(delimiter=" | ")
        ml.update(loss=1.0, acc=0.5)
        ml.update(loss=0.25)
        assert list(ml.log_every(range(5), print_freq=2, header="t")) == list(range(5))
        outs.append((str(sv), sv.median, sv.avg, sv.global_avg, str(ml), capsys.readouterr().out))
    assert outs[1] == outs[0]
    assert outs[1][2] == 3.0 and outs[1][3] == 2.5


def test_setup_logging_writes_info_log(tmp_path):
    logger = port_logging.setup_logging(str(tmp_path), name="tvts_torch_test", verbosity=1)
    logger.info("hello")
    for h in logger.handlers:
        h.flush()
    assert "hello" in (tmp_path / "info.log").read_text()
    assert port_logging.setup_logging(None, name="tvts_torch_test").handlers  # console only


def test_retrieval_vis_html_equals_jax(tmp_path):
    from tvts_tpu.utils.visualizer import RetrievalVis as JaxRetrievalVis

    sims = np.random.default_rng(0).standard_normal((6, 3)).astype(np.float32)
    meta = {"paths": ["a.mp4", "b <1>.mp4", "c.mp4"],
            "raw_captions": ["cap a", "cap & b", "cap c", "d", "e", "f"]}
    pages = []
    for cls, sub in ((JaxRetrievalVis, "jax"), (RetrievalVis, "port")):
        vis = cls("exp", str(tmp_path / sub), src_video_dir="/videos", num_samples=4)
        path = vis.visualize_ranking(sims, epoch=2, meta=meta, topk=2)
        pages.append(open(path).read())
        assert cls("exp", str(tmp_path / sub), vis_vid_freq=3).visualize_ranking(
            sims, epoch=2, meta=meta) is None
    assert pages[1] == pages[0] and "GT rank" in pages[1] and "cap &amp; b" in pages[1]


@pytest.mark.parametrize("spec", ["min val_loss_0", "max val_0_t2v_metrics_R1", "off"])
def test_monitor_equals_jax(spec):
    from tvts_tpu.utils.checkpoint import Monitor as JaxMonitor

    logs = [{"val_loss_0": 0.5, "val_0_t2v_metrics_R1": 10.0}, {"val_loss_0": 0.5},
            {"val_loss_0": 0.75, "val_0_t2v_metrics_R1": 12.5}, {"loss_0": 1.0},
            {"val_loss_0": 0.25, "val_0_t2v_metrics_R1": 9.0}]
    got, want = Monitor(spec), JaxMonitor(spec)
    assert (got.mode, got.metric, got.best) == (want.mode, want.metric, want.best)
    for log in logs:
        assert got.improved(log) == want.improved(log)
        assert got.best == want.best
    with pytest.raises(ValueError):
        Monitor("least val_loss_0")


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------
def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    from tvts_torch.utils.profiling import SPANS_SUFFIX, annotate, trace, trace_artifacts

    log_dir = str(tmp_path / "prof")
    with port_logging.profile_trace(log_dir):
        with annotate("probe-step"):
            (torch.arange(1024.0) ** 2).sum().item()
    arts = trace_artifacts(log_dir)
    # the trace turned the spans on: the annotation is the program's span,
    # and its records are written beside the chrome trace
    assert len(arts) == 1 and '"tvts::probe-step"' in open(arts[0]).read()
    (records,) = trace_artifacts(log_dir, SPANS_SUFFIX)
    assert json.load(open(records))["spans"]["probe-step"]["calls"] == 1
    with pytest.raises(RuntimeError, match="inside"):
        with trace(str(tmp_path / "p2")):
            raise RuntimeError("a failure inside the window propagates")
