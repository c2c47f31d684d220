"""step_ms_p90: the 90th percentile of the window's step times, each the
time between the CUDA events recorded at the ends of consecutive steps (the
first from the event at the window's start)."""

from benchmark.harness import percentile


def read(r):
    return percentile(r.window.step_ms, 90)
