"""Timeline profiling and step timing (counterpart of tvts_tpu/utils/profiling.py;
the reference has no profiler).

- `annotate(name)`: a named range on the profiler's timeline
  (torch.profiler.record_function), and an NVTX range where CUDA is present;
- `trace(log_dir)`: torch.profiler over the CPU and, where CUDA is present,
  the card, its chrome trace written into `log_dir` (`trace_artifacts` lists
  them). The JAX package swallows a profiler that cannot start; here its
  error propagates;
- `StepTimer`: per-step wall times after a warm-up; on the card each mark
  records a CUDA event and synchronises on it, so a step's time is the
  device's, not the time to enqueue it; on the CPU the host clock.
"""

from __future__ import annotations

import contextlib
import glob
import os
import time

import torch


@contextlib.contextmanager
def annotate(name: str):
    """A named region on the profiler timeline (and NVTX where CUDA is present)."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region into ``log_dir`` (a chrome trace,
    `*.pt.trace.json`, which TensorBoard's profiler plugin and
    chrome://tracing read). Yields the torch.profiler.profile object."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def trace_artifacts(log_dir: str) -> list[str]:
    """The trace files under ``log_dir``, newest first."""
    return sorted(glob.glob(os.path.join(log_dir, "*.pt.trace.json")), key=os.path.getmtime,
                  reverse=True)


class StepTimer:
    """Per-step wall times with a warm-up skip. Call ``mark()`` once a step,
    after the step was dispatched: interval i ends at mark i + 1, and the
    first `warmup` intervals are not recorded. On the card (``device`` a
    CUDA device) a mark records a CUDA event and waits for it, so the work
    queued so far has run; elsewhere it reads the host clock alone."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.device = torch.device(device) if device is not None else None
        self._times: list[float] = []
        self._count = 0
        self._last = None

    def mark(self) -> float | None:
        """Record a step boundary; the step's seconds (None during warm-up)."""
        if self.device is not None and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            event.synchronize()
        now = time.perf_counter()
        self._count += 1
        dt = None
        if self._last is not None and self._count - 1 > self.warmup:
            dt = now - self._last
            self._times.append(dt)
        self._last = now
        return dt

    @property
    def times(self) -> list[float]:
        return list(self._times)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        ts = sorted(self._times)
        n = len(ts)
        return {"steps": n, "mean_s": sum(ts) / n, "p50_s": ts[n // 2], "min_s": ts[0],
                "max_s": ts[-1], "steps_per_s": n / sum(ts)}
