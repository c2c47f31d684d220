"""`correct` at the tiny size on the CPU: true for the program as it is,
false for the lower-precision control in the program's place, and false for
a whole run with the timed path broken underneath by each fault a cell can
have (a step that leaves its state unchanged, half of the batch left out and
the mean taken over the rest, an answer altered where it is produced). One
chip: no exchange between chips to leave out."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import tiny_cell


def _run(cell):
    return harness.run(cell, 2**31 + 11, 0.2, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", ["b16.extract", "b16.pretrain"])
def test_program_is_correct(spec, bench, name):
    result = _run(tiny_cell(spec, bench, name))
    assert result["correct"], result["checks"]
    assert result["failed"] == 0


@pytest.mark.parametrize("name", ["b16.extract", "b16.pretrain"])
def test_traced_run_is_correct(spec, bench, monkeypatch, name):
    """A --trace 1 run on the CPU: correct, with every per-layer metric that
    reads without a device (the profiler records no device activity here)."""
    monkeypatch.setattr(harness, "PROFILE_ATTEMPTS", 1)
    result = harness.run(tiny_cell(spec, bench, name), 2**31 + 19, 0.2, True, "cpu",
                         time.perf_counter())
    assert result["correct"], result["checks"]
    spans = {"fwd_ms", "bwd_ms", "opt_ms"} if name == "b16.pretrain" else set()
    assert set(result["metrics"]) == {"host_ms", "mfu"} | spans


@pytest.mark.parametrize("name", ["b16.extract", "b16.pretrain"])
def test_control_is_not_correct(spec, bench, name):
    cell = tiny_cell(spec, bench, name)
    numbers = control.readings(cell, 2**31 + 11, "cpu", "fp8")
    assert any(numbers[name] > limit for name, limit in cell.limits.items())


def _extract_fault(kind):
    """A broken space_time_vit_fused_forward for the extraction entry."""
    from tvts_torch.ops import fused_forward

    real, last = fused_forward.space_time_vit_fused_forward, []

    def broken(model, video, keep=None, need_tokens=True):
        pooled, tokens = real(model, video, keep, need_tokens)
        if kind == "unchanged_state":  # hands back the previous call's answers
            last.append(pooled)
            return last[-2] if len(last) > 1 else pooled, tokens
        pooled = pooled.clone()
        if kind == "half_batch":
            h = pooled.shape[0] // 2
            pooled[h:] = pooled[:h].mean(0)
        else:
            pooled[0] = -pooled[0]
        return pooled, tokens
    return broken


def _pretrain_fault(kind, monkeypatch):
    from tvts_torch.train import optim, step

    if kind == "unchanged_state":
        make = optim.make_optimizer

        def frozen(model, cfg):
            opt = make(model, cfg)
            opt.step = lambda *a, **k: None
            return opt
        monkeypatch.setattr(optim, "make_optimizer", frozen)
    elif kind == "half_batch":
        losses = step._losses

        def half(outputs, batch, *args, **kwargs):
            h = outputs[1].shape[0] // 2
            kept = tuple(None if o is None else o[:h] for o in outputs)
            labels = {"labels": batch["labels"][:h]} if "labels" in batch else {}
            return losses(kept, labels, *args, **kwargs)
        monkeypatch.setattr(step, "_losses", half)
    else:
        loss = step.norm_softmax_loss

        def altered(sim, temperature=0.05):
            sim = sim.clone()
            sim[0, 0] = sim[0, 1]
            return loss(sim, temperature)
        monkeypatch.setattr(step, "norm_softmax_loss", altered)


@pytest.mark.parametrize("kind", ["unchanged_state", "half_batch", "altered_answer"])
@pytest.mark.parametrize("name", ["b16.extract", "b16.pretrain"])
def test_broken_timed_path_is_not_correct(spec, bench, monkeypatch, name, kind):
    if name == "b16.extract":
        from tvts_torch.eval import embed

        monkeypatch.setattr(embed, "space_time_vit_fused_forward", _extract_fault(kind))
    else:
        _pretrain_fault(kind, monkeypatch)
    result = _run(tiny_cell(spec, bench, name))
    assert not result["correct"], result["checks"]


@pytest.mark.gpu
def test_one_cell_on_the_card(card):
    """On the card: the B/16 extraction cell at its own size for a short
    window comes out correct (run with `python -m pytest -m gpu benchmark/tests`)."""
    import json

    from benchmark.tests.conftest import ROOT

    cell = harness.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), "b16.extract")
    result = harness.run(cell, 2**31 + 13, 2.0, False, card, time.perf_counter())
    assert result["correct"], result["checks"]
    torch.cuda.empty_cache()
