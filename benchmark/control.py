"""The check's control and planted faults, at a cell's own size:

    python3 benchmark/control.py --workload <cell> --seeds 11 12 13 [--modes fp8 ...]

For each seed and mode it prints one JSON line with the numbers the cell's
check compares, with the program's place taken by the plain reference in a
lower precision ("fp8": float8 e4m3 operands, the step below the bf16 the
configurations state) or by the reference with a planted fault (a training
cell's "half_batch" and "altered_answer", reference/train.py). Each number
must read above its limit on at least one of the cell's numbers, and the
smallest such reading sets the limit's upper end. The benchmark's own runs
do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def readings(cell, seed: int, device, mode: str) -> dict:
    """name -> number of the check with `mode` in the program's place."""
    session = cell.driver().Session(cell, seed, harness.Device(device))
    rows = (session.control("fp8") if mode == "fp8" else session.control("f32", fault=mode))
    return {name: value for name, value, _ in rows}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--modes", nargs="+", default=["fp8"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    for mode in args.modes:
        for seed in args.seeds:
            t0 = time.perf_counter()
            numbers = readings(cell, seed, "cuda", mode)
            print(json.dumps({"workload": cell.name, "mode": mode, "seed": seed,
                              "seconds": time.perf_counter() - t0, **numbers}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
