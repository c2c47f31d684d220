"""The sub-path ranges behind kernel_roofline: every entry the benchmark times
exists in the program, a missing one stops the run, each cell's path calls
every entry its mix lists, and kernel_roofline and idle_share read nothing
where their inputs are missing."""

from __future__ import annotations

import json
import types

import pytest

from benchmark import harness, spans
from benchmark.tests.conftest import ROOT, tiny_cell

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def _load_metric(name):
    return harness.load_file(ROOT / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}")


def test_every_entry_resolves():
    assert len(spans.resolve()) == len(spans.FORWARD) + len(spans.BACKWARD)


def test_a_missing_entry_stops_the_ranges(monkeypatch):
    from tvts_torch.ops import block_backward, fused_forward

    monkeypatch.delattr(fused_forward, "fused_time_block")
    monkeypatch.delattr(block_backward._MlpSubpath, "backward")
    with pytest.raises(LookupError, match="fused_time_block.*_MlpSubpath.backward"):
        with spans.subpath_ranges():
            pass


@pytest.mark.parametrize("name", CELLS)
def test_mix_lists_known_entries(name):
    mix = harness.Cell(SPEC, name).traffic
    assert mix["subpaths"], name
    assert set(mix["subpaths"]) <= set(spans.entry_names())


@pytest.mark.parametrize("name", ["b16.extract", "b16.pretrain"])
def test_path_calls_every_listed_entry(spec, bench, name):
    cell = tiny_cell(spec, bench, name)
    session = cell.driver().Session(cell, 2**31 + 17, harness.Device("cpu"))
    session.set_up()
    session.begin_window()
    with spans.subpath_ranges() as calls:
        for _ in range(2):  # both loaders of a round robin
            session.step()
    called = {harness.entry_of(label) for label, _ in calls}
    assert set(cell.traffic["subpaths"]) <= called, called
    assert all(bound > 0 for _, bound in calls)


def test_roofline_reads_nothing_where_a_listed_entry_made_no_call():
    read = _load_metric("kernel_roofline").read
    cell = types.SimpleNamespace(traffic={"subpaths": ["a", "b"]})
    both = {"calls": [("a", 2.0, 1.0), ("b", 2.0, 0.5)]}
    assert read(types.SimpleNamespace(cell=cell, profile=both)) == pytest.approx(37.5)
    one = {"calls": [("a", 2.0, 1.0), ("a", 2.0, 0.5)]}
    assert read(types.SimpleNamespace(cell=cell, profile=one)) is None
    assert read(types.SimpleNamespace(cell=cell, profile=None)) is None


def test_idle_share_is_one_trace():
    read = _load_metric("idle_share").read
    assert read(types.SimpleNamespace(busy={"busy_s": 0.75, "window_s": 1.0})) == 25.0
    assert read(types.SimpleNamespace(busy=None)) is None
