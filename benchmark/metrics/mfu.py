"""mfu: the model FLOPs of the traced window's steps (benchmark/flops.py,
from the shapes; recomputation not counted) over its host seconds, as a
share of the card's dense bf16 peak, in %. The window runs before the
profiler starts, so profiling does not lower it."""

from benchmark.flops import PEAK_FLOPS


def read(r):
    return 100.0 * r.window.flops / r.window.seconds / PEAK_FLOPS
