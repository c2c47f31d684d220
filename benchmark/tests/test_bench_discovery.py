"""A cell, a traffic mix and a per-layer metric added as new files are found
by name, with no file of the harness edited."""

from __future__ import annotations

import json
import shutil
import time

from benchmark import harness
from benchmark.tests.conftest import ROOT, TINY_LIMITS


def test_new_cell_mix_and_metric_are_found(spec, tmp_path):
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "traffic" / "extract_b2.json").write_text(json.dumps(
        {"kind": "extract", "batch": 2, "pool": 2, "checked_batches": 1, "reference_chunk": 2}))
    (bench / "limits" / "tiny.extract.json").write_text(json.dumps(TINY_LIMITS["b16.extract"]))
    (bench / "metrics" / "batches.py").write_text(
        '"""batches: steps the traced window dispatched."""\n\n\n'
        "def read(r):\n    return len(r.window.steps)\n")
    spec["workloads"].append({"name": "tiny.extract", "config": "tvtsv2_b16",
                              "traffic": "extract_b2", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "batches", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "entry", "moves": "clips_per_s",
                              "workloads": ["tiny.extract"]})
    cell = harness.Cell(spec, "tiny.extract", bench_dir=bench, root=ROOT)
    assert cell.traffic["batch"] == 2
    assert [m["name"] for m in cell.per_layer] == ["batches"]
    harness_attempts = harness.PROFILE_ATTEMPTS
    try:
        harness.PROFILE_ATTEMPTS = 1  # the CPU records no device activity
        result = harness.run(cell, 5, 0.2, True, "cpu", time.perf_counter())
    finally:
        harness.PROFILE_ATTEMPTS = harness_attempts
    assert result["metrics"]["batches"] == {"value": result["attempted"], "unit": "steps"}
    assert result["correct"]
    assert list(result)[-1] == "checks"
