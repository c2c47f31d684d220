"""Logging and scalar writing (counterpart of tvts_tpu/utils/logging.py;
reference v2/logger/: a console handler and a rotating info.log per run
directory; TensorboardWriter's scalar tags with steps_per_sec,
logger/visualization.py:5-106; v1/downstream/utils.py MetricLogger and
SmoothedValue, :31-176).

The scalar sink is JSONL, one {"tag", "value", "step", "ts"} a line; with
`tensorboard=True` the same scalars also go to TensorBoard event files
(utils/tb_events.py). `profile_trace` is torch.profiler (utils/profiling.trace).
"""

from __future__ import annotations

import collections
import json
import logging
import logging.handlers
import os
import time


def setup_logging(log_dir: str | None = None, name: str = "tvts_torch",
                  verbosity: int = 2) -> logging.Logger:
    level = {0: logging.WARNING, 1: logging.INFO, 2: logging.DEBUG}.get(
        verbosity, logging.INFO)
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, "info.log"), maxBytes=10 * 1024 * 1024,
            backupCount=5)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


class ScalarWriter:
    """JSONL scalar sink with steps/sec like the reference TensorboardWriter
    (visualization.py:5). With `tensorboard=True` it additionally writes real
    TensorBoard event files (utils/tb_events.py, no TF dependency)."""

    def __init__(self, log_dir: str, flush_every: int = 50,
                 tensorboard: bool = False):
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._count = 0
        self._flush_every = flush_every
        self._last_step_time = time.time()
        self._last_step = 0
        self._tb = None
        if tensorboard:
            from tvts_torch.utils.tb_events import EventWriter

            self._tb = EventWriter(log_dir)

    def __call__(self, tag: str, value: float, step: int):
        now = time.time()
        if step > self._last_step:
            sps = (step - self._last_step) / max(now - self._last_step_time, 1e-9)
            self._write("steps_per_sec", sps, step, now)
            self._last_step, self._last_step_time = step, now
        self._write(tag, float(value), step, now)

    def _write(self, tag, value, step, ts):
        self._f.write(json.dumps({"tag": tag, "value": value, "step": int(step),
                                  "ts": ts}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._count += 1
        if self._count % self._flush_every == 0:
            self._f.flush()
            if self._tb is not None:
                self._tb.flush()

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class SmoothedValue:
    """Windowed + global average tracker (reference v1/downstream/utils.py:31-)."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    def __str__(self):
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: dict[str, SmoothedValue] = collections.defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable, print_freq: int, header: str = ""):
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        n = len(iterable) if hasattr(iterable, "__len__") else None
        end = time.time()
        for i, obj in enumerate(iterable):
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % print_freq == 0:
                eta = iter_time.avg * (n - i) if n else float("nan")
                print(f"{header} [{i}{'/' + str(n) if n else ''}] "
                      f"eta: {eta:.0f}s {self} time: {iter_time}", flush=True)
        print(f"{header} total: {time.time() - start:.1f}s", flush=True)


def profile_trace(log_dir: str):
    """A torch.profiler trace of the enclosed region into log_dir."""
    from tvts_torch.utils.profiling import trace

    return trace(log_dir)
