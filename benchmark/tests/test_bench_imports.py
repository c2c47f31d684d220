"""What the benchmark imports: no module of JAX or of the JAX package, by
whole top-level name, anywhere in it; nothing of the program in the plain
reference; and, at run time, nothing of either loaded by the harness and the
reference."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.conftest import ROOT

BENCH = ROOT / "benchmark"


def _imported(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not _imported(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "tvts_torch" not in _imported(path)
    assert not _imported(path) - {"__future__", "re", "torch", "benchmark"}


def test_loaded_modules():
    """Run in a fresh interpreter: the reference loads no module of the
    program, and the harness, traffic modules and readers load none of JAX."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1]);"
        "import benchmark.reference.model, benchmark.reference.train;"
        "top = {m.split('.')[0] for m in sys.modules}; print(int('tvts_torch' in top));"
        "from benchmark import harness, control, spans;"
        "from pathlib import Path;"
        "[harness.load_file(p, 'm' + p.stem.replace('.', '_'))"
        " for d in ('traffic', 'metrics')"
        " for p in (Path(sys.argv[1]) / 'benchmark' / d).glob('*.py')];"
        "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)], capture_output=True, text=True,
                         check=True).stdout.split()
    assert out == ["0", "[]"]
