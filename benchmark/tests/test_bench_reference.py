"""The plain reference against the port's eager path in float32 on the CPU,
at the tiny configuration: the video tower (pooled and tokens, with a tube
mask), the text tower, the sort head, and the pretraining step with AdamW and
frozen text blocks (three steps through the cell's own session, the kernel
paths' plain versions on the CPU)."""

from __future__ import annotations

import pytest
import torch

from benchmark import feed, harness, program, weights
from benchmark.reference import model as ref
from benchmark.tests.conftest import TINY, tiny_cell

TOL = 2e-5  # float32 against float32: the two sum in different orders


def _port(seed: int):
    from tvts_torch.models.tvts_v2 import TVTSv2

    model = TVTSv2(program.model_config(TINY))
    model.load_state_dict(weights.make(TINY, seed, "cpu"))
    return model.eval()


def _close(got, want, tol=TOL):
    scale = want.abs().max().clamp_min(1e-6)
    assert float((got - want).abs().max() / scale) < tol


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_video_tower_matches_port(seed):
    model, P = _port(seed), weights.make(TINY, seed, "cpu")
    gen = feed.generator(seed, "cpu")
    video = feed.clips(gen, 1, 3, TINY["vision"], "cpu")[0]
    keep = feed.keep_sets(gen, 3, 4, 2, "cpu")
    with torch.no_grad():
        want_pooled, want_tokens = model.compute_video(video, keep)
        pooled, tokens = ref.video_tower(ref.Numerics(), P, TINY["vision"], video, keep)
    _close(pooled, want_pooled)
    _close(tokens, want_tokens)


def test_text_tower_and_sort_head_match_port():
    model, P = _port(3), weights.make(TINY, 3, "cpu")
    gen = feed.generator(3, "cpu")
    ids = feed.caption_ids(gen, 8, 8, (3, 8), 0.25, "cpu")
    tokens = torch.randn(2, 5, 32, generator=gen)
    with torch.no_grad():
        text = ref.text_tower(ref.Numerics(), P, TINY["text"], ids)
        _close(text, model.compute_text(ids))
        per_clip = text.view(4, 2, -1).transpose(0, 1)
        _close(ref.sort_head(ref.Numerics(), P, TINY["sort"], per_clip, tokens),
               model.pred_model(per_clip, tokens))


def test_train_step_matches_port(spec, bench, monkeypatch):
    """The session's three checked steps with the program computing in
    float32 read as the reference does, and frozen blocks stay bit for bit."""
    build = program.build

    def f32_build(*args, **kwargs):
        config, model = build(*args, **kwargs)
        model.set_compute_dtype(None)
        return config, model

    monkeypatch.setattr(program, "build", f32_build)
    cell = tiny_cell(spec, bench, "b16.pretrain")
    session = cell.driver().Session(cell, 11, harness.Device("cpu"))
    session.set_up()
    session.release()
    numbers = {name: value for name, value, _ in session.check()}
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-4
    assert numbers["change_gap"] < 1e-4
    assert numbers["frozen_moved"] == 0
    assert session.readings["grad_norms"] and all(
        not name.startswith(f"text_model.resblocks.{i}.") for i in range(session.tune_from)
        for name in session.readings["grad_norms"])
