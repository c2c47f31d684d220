"""The program's spans (tvts_torch/utils/profiling.py): off by default at the
cost of one check, the span tree of the extraction entry and of a train
step on a tiny TVTSv2 on the CPU, the records a trace writes beside it,
every sub-path entry the benchmark times carrying a span of its name and
the geometry its bound needs, and the host-sync count (its attribution on
the CPU with the debug mode stood in for, a mode the caller set left alone;
a planted `.item()` on the card).

No JAX here, so the `gpu` test runs on the card with
    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_spans.py -q
"""

from __future__ import annotations

import functools
import importlib
import json
import threading
import warnings

import pytest
import torch

from tvts_torch.models.configs import SortConfig, TextConfig, TVTSv2Config, VisionConfig
from tvts_torch.models.tvts_v2 import TVTSv2
from tvts_torch.utils import profiling

LAYERS = 3
CFG = TVTSv2Config(
    name="tiny",
    vision=VisionConfig(input_resolution=32, patch_size=16, width=64, layers=LAYERS, heads=2,
                        output_dim=32, num_frames=2, mask_ratio=0.5),
    text=TextConfig(context_length=8, width=64, layers=3, heads=2, output_dim=32),
    sort=SortConfig(embed_dim=32, depth=2, num_heads=2), num_clips=4)


@pytest.fixture
def spans():
    """Spans on for the test, off and cleared after."""
    profiling.spans_on(True)
    try:
        yield
    finally:
        profiling.spans_on(False)
        profiling.take_spans()


def _tree(records: dict) -> dict:
    return {name: (rec["calls"], rec["parents"]) for name, rec in records["spans"].items()}


def test_spans_are_off_by_default_and_record_nothing(monkeypatch):
    from tvts_torch.ops import block_kernels as bk

    assert profiling.spans_on(False) is False
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a) or pytest.fail("a range opened"))
    x = torch.randn(2, 1 + 2 * 4, 64)
    ln, w, b = torch.ones(64), torch.randn(192, 64) * 0.05, torch.zeros(192)
    bk.fused_time_block(x, ln, ln * 0, w, b, w[:64], b[:64], num_frames=2, num_heads=2)
    assert profiling.annotate("stem") is profiling.annotate("pool")  # the shared no-op
    assert entered == [] and profiling.take_spans() == {"spans": {}}


def test_extraction_entry_records_the_span_tree(spans):
    _extract_once()
    got = profiling.take_spans()
    top = {"embed_video": 1}
    assert _tree(got) == {
        "embed_video": (1, {None: 1}), "stem": (1, top),
        "fused_time_block": (LAYERS, {"embed_video": LAYERS}),
        "fused_space_block": (LAYERS - 1, {"embed_video": LAYERS - 1}),
        "fused_mlp_block": (LAYERS - 1, {"embed_video": LAYERS - 1}),
        "fused_space_cls_only": (1, top), "pool": (1, top)}
    time_block = got["spans"]["fused_time_block"]
    assert len(time_block["host_ms"]) == LAYERS and time_block["device_ms"] == []
    assert time_block["geometry"][0] == {"B": 2, "S": 9, "D": 64, "num_frames": 2,
                                         "num_heads": 2}
    assert got["spans"]["fused_mlp_block"]["geometry"][0] == {
        "B": 2, "S": 9, "D": 64, "hidden": 256, "act": "quick_gelu", "save_hidden": False}
    # the CLS row
    assert got["spans"]["pool"]["geometry"] == [{"B": 2, "S": 1, "D": 64, "need_tokens": False}]
    assert "host_syncs" not in got  # the counter is armed only where CUDA is present
    assert profiling.take_spans() == {"spans": {}}


def _extract_once() -> None:
    from tvts_torch.eval.embed import make_embed_fns

    torch.manual_seed(0)
    model = TVTSv2(CFG.eval_config()).eval()
    _, embed_video = make_embed_fns(model, use_fused=True)
    embed_video(torch.randn(2, 2, 3, 32, 32), torch.arange(4)[None].expand(2, -1))


def _train_once() -> None:
    from tvts_torch.ops.fused_forward import train_apply
    from tvts_torch.train.optim import OptimizerConfig, make_optimizer
    from tvts_torch.train.step import make_train_step

    torch.manual_seed(0)
    model = TVTSv2(CFG)
    ocfg = OptimizerConfig(text_layers=3, text_tune_layers=2)
    apply = functools.partial(train_apply, mlp_kernel=True, text_tune_from=1)
    step = make_train_step(model, make_optimizer(model, ocfg), ocfg, apply_fn=apply)
    B, n = 2, CFG.num_clips
    ids = torch.randint(1, 49000, (n * B, 8))
    ids[:, 5] = 49407  # EOT, the largest id
    step({"video": torch.randn(B, 2, 3, 32, 32), "text_ids": ids,
          "keep_ind": torch.stack([torch.randperm(4)[:2] for _ in range(B)]),
          "labels": torch.arange(n).repeat(B, 1)})


def test_train_step_records_its_phases_and_the_backward_spans(spans):
    _train_once()
    tree = _tree(profiling.take_spans())
    assert tree["train_step"] == (1, {None: 1})
    for phase in ("forward", "loss", "backward", "optimizer"):
        assert tree[phase] == (1, {"train_step": 1}), phase
    assert "grad_sync" not in tree  # one process: no gradient is summed
    for name in ("stem", "time_subpath", "space_subpath", "mlp_subpath", "pool",
                 "sort_transformer_fused_forward"):
        assert set(tree[name][1]) == {"forward"}, name
    for kind in ("Time", "Space", "Mlp"):
        assert tree[f"_{kind}Subpath.backward"] == (LAYERS, {"backward": LAYERS})
    # two trainable-or-frozen text blocks run H7 (the last is EOT-only), and
    # the sort head's first block; under autograd each has its backward
    assert tree["_TextSubpath.backward"] == (3, {"backward": 3})
    assert tree["text_subpath"] == (3, {"forward": 2, "sort_transformer_fused_forward": 1})


def test_trace_turns_spans_on_and_restores_the_state(tmp_path):
    """The trace turns the spans on for its window and restores the state
    before; where it turned them on, their records go beside the chrome
    trace, else they stay for whoever turned the spans on."""
    from tvts_torch.eval.embed import make_embed_fns

    model = TVTSv2(CFG.eval_config()).eval()
    _, embed_video = make_embed_fns(model, use_fused=True)
    for before in (False, True):
        log_dir = str(tmp_path / f"prof{before}")
        profiling.spans_on(before)
        try:
            with profiling.trace(log_dir):
                assert profiling.spans_on(True) is True
                embed_video(torch.randn(1, 2, 3, 32, 32), None)
            assert profiling.spans_on(before) is before
            assert ("embed_video" in profiling.take_spans()["spans"]) is before
        finally:
            profiling.spans_on(False)
        text = open(profiling.trace_artifacts(log_dir)[0]).read()
        assert '"tvts::stem"' in text and '"tvts::fused_mlp_block"' in text
        written = profiling.trace_artifacts(log_dir, profiling.SPANS_SUFFIX)
        assert len(written) == (0 if before else 1)
        if not before:
            records = json.load(open(written[0]))["spans"]
            assert (records["embed_video"]["calls"], records["embed_video"]["parents"]) == (
                1, {"null": 1})
            assert records["stem"]["parents"] == {"embed_video": 1}
            assert records["fused_time_block"]["geometry"][0]["num_frames"] == 2


def _bound_ms(name: str, g: dict) -> float:
    """The benchmark's bound of a sub-path call (benchmark/spans.py) from the
    geometry its program span recorded alone."""
    from benchmark import flops

    B, S, D = g["B"], g["S"], g["D"]
    backward = name.endswith(".backward")
    if name == "fused_space_cls_only":
        return flops.bound_ms(*flops.cls_only_work(B, S, D, g["num_heads"]))
    kind = next(k for k in ("time", "space", "mlp", "text") if k in name.lower())
    if kind == "mlp":
        work = flops.mlp_work(B * S, D, backward, g["save_hidden"], g["hidden"])
    elif kind == "text":
        work = flops.text_work(B, S, D, g["num_heads"], g["causal"], backward,
                               frozen=backward and g["frozen"])
    else:
        T, H = g["num_frames"], g["num_heads"]
        if name.endswith("_subpath"):  # the training forward, which saves for its backward
            work = flops.saving_forward_work(kind, B, T, (S - 1) // T, D, H)
        else:
            work = flops.attention_work(kind, B, T, (S - 1) // T, D, H, backward=backward)
    return flops.bound_ms(*work)


def test_span_geometry_gives_each_benchmark_entry_its_bound(spans):
    """Each sub-path call's recorded geometry holds what the benchmark's
    bound of the call is computed from (hidden width and saved hidden
    included): every entry of benchmark/spans.py, from an extraction and a
    train step."""
    from benchmark import spans as bench_spans
    from benchmark.harness import entry_of

    with bench_spans.subpath_ranges() as calls:
        _extract_once()
        _train_once()
    records = profiling.take_spans()["spans"]
    by_entry: dict = {}
    for label, bound in calls:
        by_entry.setdefault(entry_of(label), []).append(bound)
    assert sorted(by_entry) == sorted(bench_spans.entry_names())
    for name, bounds in by_entry.items():
        got = [_bound_ms(name, g) for g in records[name]["geometry"]]
        assert got == pytest.approx(bounds, rel=1e-12), name


def test_every_benchmark_entry_has_a_program_span_of_its_name():
    from benchmark import spans as bench_spans

    names = []
    for module, attr, _ in bench_spans.FORWARD:
        names.append(getattr(importlib.import_module(module), attr).span)
    for module, cls, _ in bench_spans.BACKWARD:
        owner = getattr(importlib.import_module(module), cls)
        names.append(owner.__dict__["backward"].__func__.span)
    assert names == bench_spans.entry_names()


def test_sync_warnings_count_under_the_innermost_span(monkeypatch):
    """The counter's attribution with CUDA's debug mode stood in for: a
    sync warning inside a span counts there, one on a thread with no span
    open counts under the spans' owner's innermost span, one outside every
    span counts nowhere, all are swallowed, other warnings pass, and the
    mode and warning hooks are restored."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
    filters = list(warnings.filters)
    show = warnings.showwarning
    sync = profiling.SYNC_WARNING + " (a stand-in)"
    with pytest.warns(UserWarning, match="not a sync") as passed:
        profiling.spans_on(True)
        try:
            warnings.warn(sync)
            with profiling.annotate("outer"):
                with profiling.annotate("inner"):
                    warnings.warn(sync)
                    warnings.warn(sync)

                def engine_thread():
                    warnings.warn(sync)
                    with profiling.annotate("on_thread"):
                        warnings.warn(sync)
                worker = threading.Thread(target=engine_thread)
                worker.start()
                worker.join(timeout=30)
                assert not worker.is_alive()
                warnings.warn("not a sync")
        finally:
            profiling.spans_on(False)
    got = profiling.take_spans()
    assert got["host_syncs"] == {"total": 4, "by_span": {"inner": 2, "outer": 1, "on_thread": 1}}
    assert got["spans"]["on_thread"]["parents"] == {"outer": 1}
    assert [str(w.message) for w in passed] == ["not a sync"]
    assert modes == ["warn", 0]
    assert warnings.filters == filters and warnings.showwarning is show
    assert "host_syncs" not in profiling.take_spans()


def test_a_sync_debug_mode_the_caller_set_is_left_alone(monkeypatch):
    """Where the caller set CUDA's sync debug mode ("warn" or "error"), the
    spans leave it and the warning hooks as they are and count nothing."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", lambda name: None)
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop", lambda: None)
    filters, show = list(warnings.filters), warnings.showwarning
    profiling.spans_on(True)
    try:
        assert warnings.filters == filters and warnings.showwarning is show
        with pytest.warns(UserWarning, match="stand-in"):
            with profiling.annotate("probe"):
                warnings.warn(profiling.SYNC_WARNING + " (a stand-in)")
    finally:
        profiling.spans_on(False)
    got = profiling.take_spans()
    assert modes == [] and "host_syncs" not in got and got["spans"]["probe"]["calls"] == 1
    assert warnings.filters == filters and warnings.showwarning is show


@pytest.mark.gpu
def test_a_planted_item_counts_one_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(1024, device="cuda")
    mode = torch.cuda.get_sync_debug_mode()
    profiling.spans_on(True)
    try:
        with profiling.annotate("probe", x):
            (x * 2).sum().item()
        x.sum().item()  # outside every span: not counted
        torch.cuda.synchronize()
    finally:
        profiling.spans_on(False)
    got = profiling.take_spans()
    assert got["host_syncs"] == {"total": 1, "by_span": {"probe": 1}}
    assert len(got["spans"]["probe"]["device_ms"]) == 1
    assert got["spans"]["probe"]["device_ms"][0] > 0
    assert torch.cuda.get_sync_debug_mode() == mode
