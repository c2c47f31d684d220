"""The classification cell (`g14.classify`: VideoMAE V2 ViT-g/14 through the
port's make_cls_eval_step(use_fused=True)) at a tiny size with the ViT-g
block's shape on the CPU: the cell, its mix and its metrics are found by
name; the plain reference's stem is the published Conv3d; flops_joint's
arithmetic against a hand count; each reader on synthetic span records;
`correct` true for the program, false for the fp8 control and for a timed
path broken underneath."""

from __future__ import annotations

import json
import time
import types

import pytest
import torch
import torch.nn.functional as F

from benchmark import control, flops, flops_joint, harness
from benchmark.reference import model as ref
from benchmark.reference import videomae
from benchmark.tests.conftest import ROOT

CELL = "g14.classify"
TINY = {"img_size": 28, "patch_size": 14, "num_frames": 4, "tubelet_size": 2, "embed_dim": 176,
        "depth": 2, "num_heads": 2, "mlp_ratio": 48 / 11, "num_classes": 10}
# the tiny size's limits, from its CPU readings on five seeds: the bf16 program
# reads logits 0.0040-0.0076, features 0.0044-0.0055; the fp8 control 0.052-0.090
# and 0.052-0.058
TINY_LIMITS = {"logit_err": 0.03, "feature_err": 0.025}
VIT_G = json.loads((ROOT / "benchmark" / "configs" / "videomaev2_g14.json").read_text())
JOINT_METRICS = ["joint_core_roofline", "joint_block_roofline", "joint_attn_ms", "joint_mlp_ms"]


@pytest.fixture
def cell(tmp_path):
    """The cell at the tiny size: batch 3, the reference 2 clips at once."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "tiny_g.json").write_text(json.dumps(TINY))
    for config in spec["configs"]:
        if config["name"] == "videomaev2_g14":
            config["file"] = str(tmp_path / "tiny_g.json")
    out = harness.Cell(spec, CELL)
    out.traffic = dict(out.traffic, batch=3, reference_chunk=2)
    out.limits = TINY_LIMITS
    return out


def _metric(name):
    return harness.load_file(ROOT / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}")


def test_cell_mix_and_metrics_are_found():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell(spec, CELL)
    assert cell.chips == 1 and cell.traffic["kind"] == "classify"
    assert cell.config["model"] == "vit_giant_patch14_224"
    assert (cell.config["embed_dim"], cell.config["num_heads"], cell.config["depth"]) == (1408,
                                                                                          16, 40)
    assert int(cell.config["embed_dim"] * cell.config["mlp_ratio"]) == 6144
    assert videomae.tokens(cell.config) == 2048
    assert set(cell.limits) == {"logit_err", "feature_err"}
    assert [m["name"] for m in cell.end_to_end] == ["clips_per_s", "step_ms_p90", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == {"host_ms", "mfu", "idle_share", *JOINT_METRICS}
    for name in JOINT_METRICS:
        assert callable(_metric(name).read)


def test_reference_stem_is_the_conv3d_and_runs():
    P = videomae.make_weights(TINY, 5, "cpu")
    video = torch.randn(2, 4, 3, 28, 28, generator=torch.Generator().manual_seed(1))
    logits, features = videomae.forward(ref.Numerics("f32"), P, TINY, video)
    assert logits.shape == (2, 10) and features.shape == (2, 176)
    assert torch.isfinite(logits).all()
    # the stem by a reshape and one product is the published Conv3d
    D, g = 176, 2
    patches = (video.reshape(2, 2, 2, 3, g, 14, g, 14).permute(0, 1, 4, 6, 3, 2, 5, 7)
               .reshape(2, 8, -1))
    mine = patches @ P["patch_embed.proj.weight"].reshape(D, -1).t() + P["patch_embed.proj.bias"]
    conv = F.conv3d(video.transpose(1, 2), P["patch_embed.proj.weight"],
                    P["patch_embed.proj.bias"], stride=(2, 14, 14)).flatten(2).transpose(1, 2)
    torch.testing.assert_close(mine, conv, rtol=1e-5, atol=1e-5)
    # the qkv weight has no bias of its own: q and v biases, k none
    assert "blocks.0.attn.qkv.bias" not in P and P["blocks.0.attn.q_bias"].shape == (176,)
    table = videomae.sinusoid_table(8, 6)
    assert torch.equal(table[0], torch.tensor([0.0, 1.0, 0.0, 1.0, 0.0, 1.0]))


def test_flops_joint_against_a_hand_count():
    # the core at the cell's shape: 4 * 88 flops a pair, 15 * 16 * 2048^2 pairs
    f, b = flops_joint.core_work(15, 2048, 16, 88)
    assert f == 4 * 88 * 15 * 16 * 2048 * 2048 == 354_334_801_920
    assert b == 2 * 15 * 2048 * 1408 * 4
    assert flops_joint.core_work(1, 3, 1, 2, causal=True) == (4 * 2 * 6, 2 * 3 * 2 * 4)
    # a block: qkv, proj (8 S D^2), the MLP (4 S D hidden), the core (4 D S^2)
    S, D, hidden = 2048, 1408, 6144
    block = 8 * S * D * D + 4 * S * D * hidden + 4 * D * S * S
    stem = 2 * S * D * 3 * 2 * 14 * 14
    assert flops_joint.classify_flops_per_clip(VIT_G) == stem + 40 * block + 2 * D * 400
    assert abs(flops_joint.classify_flops_per_clip(VIT_G) / 1e12 - 5.0856) < 1e-4
    assert flops_joint.attention_work(15, S, D, 16) == flops.text_work(15, S, D, 16, False, False)
    assert flops_joint.mlp_work(15, S, D, hidden) == flops.mlp_work(15 * S, D, False, False,
                                                                    hidden)


def _records(cls_calls=2, device=(2.0, 3.0)):
    """Synthetic take_spans() records of `cls_calls` entry calls at the cell's
    shape, each block's sub-paths and core timed `device` ms."""
    g = {"B": 15, "S": 2048, "D": 1408}
    n = 40 * cls_calls

    def rec(ms, geometry):
        return {"calls": n, "host_ms": [0.1] * n, "device_ms": [ms] * n,
                "geometry": [geometry] * n, "parents": {"cls_eval": n}}

    return {"spans": {
        "cls_eval": {"calls": cls_calls, "host_ms": [1.0] * cls_calls,
                     "device_ms": [200.0] * cls_calls, "geometry": [{}] * cls_calls,
                     "parents": {None: cls_calls}},
        "fused_text_attention_block": rec(device[0], {**g, "num_heads": 16, "head_dim": 88,
                                                      "causal": False, "eps": 1e-6}),
        "text_core": rec(1.0, {"B": 15, "S": 2048, "H": 16, "d": 88, "causal": False}),
        "fused_mlp_block": rec(device[1], {**g, "hidden": 6144, "act": "gelu",
                                           "save_hidden": False})}}


def test_build_holds_the_served_weights():
    """classify.build: nothing left on the meta device, bf16 but the
    LayerNorms, each parameter the served weight (the q/v biases folded with
    a zero k slot), the position table the sinusoid one."""
    from benchmark.traffic import classify
    from tvts_torch.downstream.model import sinusoid_table

    model = classify.build(TINY, 9, "cpu")
    want = videomae.make_weights(TINY, 9, "cpu", served=True)
    assert not model.training
    assert not any(t.is_meta for t in [*model.parameters(), *model.buffers()])
    for name, p in model.named_parameters():
        assert p.dtype == (torch.float32 if "norm" in name else torch.bfloat16), name
        if name.endswith("attn.qkv.bias"):
            pre = name[:-len("qkv.bias")]
            zero = torch.zeros_like(want[pre + "q_bias"])
            assert torch.equal(p, torch.cat([want[pre + "q_bias"], zero, want[pre + "v_bias"]]))
        else:
            assert torch.equal(p, want[name]), name
    assert torch.equal(model.pos_table, torch.from_numpy(sinusoid_table(8, 176).copy()))


def test_readers_on_synthetic_spans():
    r = types.SimpleNamespace(spans=_records())
    core = flops.bound_ms(*flops_joint.core_work(15, 2048, 16, 88))
    assert _metric("joint_core_roofline").read(r) == pytest.approx(100 * core / 1.0)
    attn_b = flops.bound_ms(*flops_joint.attention_work(15, 2048, 1408, 16))
    mlp = flops.bound_ms(*flops_joint.mlp_work(15, 2048, 1408, 6144))
    assert _metric("joint_block_roofline").read(r) == pytest.approx(100 * (attn_b + mlp) / 5.0)
    assert _metric("joint_attn_ms").read(r) == pytest.approx(40 * 2.0)
    assert _metric("joint_mlp_ms").read(r) == pytest.approx(40 * 3.0)
    # the text and sort towers' causal calls of the same span are not the joint blocks'
    mixed = _records()
    attn = mixed["spans"]["fused_text_attention_block"]
    attn["device_ms"] += [50.0] * 3
    attn["geometry"] += [dict(attn["geometry"][0], S=77, causal=True)] * 3
    r = types.SimpleNamespace(spans=mixed)
    assert _metric("joint_attn_ms").read(r) == pytest.approx(40 * 2.0)
    assert _metric("joint_block_roofline").read(r) == pytest.approx(100 * (attn_b + mlp) / 5.0)
    # nothing to read: no spans (the extraction cells, a program without them),
    # or spans without device time (the CPU)
    for spans in ({}, {"spans": {}}, {"spans": {k: dict(v, device_ms=[]) for k, v in
                                                _records()["spans"].items()}}):
        for name in JOINT_METRICS:
            assert _metric(name).read(types.SimpleNamespace(spans=spans)) is None, name


def test_program_is_correct_and_traced_run_reads(cell, monkeypatch):
    result = harness.run(cell, 2**31 + 11, 0.2, False, "cpu", time.perf_counter())
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert set(result["metrics"]) == {"clips_per_s", "step_ms_p90", "setup_s"}
    monkeypatch.setattr(harness, "PROFILE_ATTEMPTS", 1)
    traced = harness.run(cell, 2**31 + 19, 0.2, True, "cpu", time.perf_counter())
    assert traced["correct"], traced["checks"]
    assert set(traced["metrics"]) == {"host_ms", "mfu"}  # the rest read the card's spans


def test_control_is_not_correct(cell):
    numbers = control.readings(cell, 2**31 + 11, "cpu", "fp8")
    assert any(numbers[name] > limit for name, limit in cell.limits.items()), numbers


def _broken(kind):
    """A broken finetune_vit_fused_forward under the eval step."""
    from tvts_torch.ops import fused_forward

    real, last = fused_forward.finetune_vit_fused_forward, []

    def broken(model, video):
        logits = real(model, video)
        if kind == "unchanged_state":  # hands back the previous call's answers
            last.append(logits)
            return last[-2] if len(last) > 1 else logits
        logits = logits.clone()
        if kind == "half_batch":
            logits[1:] = logits[:1]
        else:
            logits[0] = -logits[0]
        return logits
    return broken


@pytest.mark.parametrize("kind", ["unchanged_state", "half_batch", "altered_answer"])
def test_broken_timed_path_is_not_correct(cell, monkeypatch, kind):
    from tvts_torch.ops import fused_forward

    monkeypatch.setattr(fused_forward, "finetune_vit_fused_forward", _broken(kind))
    result = harness.run(cell, 2**31 + 11, 0.2, False, "cpu", time.perf_counter())
    assert not result["correct"], result["checks"]


def test_a_block_left_out_is_not_correct(cell, monkeypatch):
    """The fused path without its last joint block reads false."""
    from tvts_torch.ops import fused_forward

    real = fused_forward.joint_blocks_fused_forward
    monkeypatch.setattr(fused_forward, "joint_blocks_fused_forward",
                        lambda blocks, x: real(blocks[:-1], x))
    result = harness.run(cell, 2**31 + 11, 0.2, False, "cpu", time.perf_counter())
    assert not result["correct"], result["checks"]


def test_eager_attention_on_the_timed_path_stops_set_up(cell, monkeypatch):
    from tvts_torch.downstream import engine

    monkeypatch.setattr(engine, "make_cls_eval_step",
                        lambda model, use_fused=False: torch.no_grad()(model))
    session = cell.driver().Session(cell, 3, harness.Device("cpu"))
    with pytest.raises(RuntimeError, match="eager attention"):
        session.set_up()
