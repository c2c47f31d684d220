"""Run one cell of BENCHMARK.json once on the CUDA device(s) of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (harness.py). The caches of
the toolchains that the program may use are kept at fixed places inside the
checkout; the port's own kernel library builds into tvts_torch/_build/.
"""

import time

T_START = time.perf_counter()  # setup_s counts from here: imports, build, weights, warm-up

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
