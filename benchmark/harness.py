"""The harness: runs one cell of BENCHMARK.json once and prints its result.

Everything that belongs to one cell lives in files found by name:
- BENCHMARK.json's `workloads` entry: the configuration, the traffic mix and
  the chips;
- `configs/<config>.json` (the entry's `file`): the architecture as it is run;
- `traffic/<mix>.json`: the mix's parameters, whose "kind" names the traffic
  module `traffic/<kind>.py` (its `Session` builds the program, feeds it and checks
  what it produced against the plain reference);
- `limits/<cell>.json`: the limit of each number the check compares;
- `metrics/<metric>.py`: one reader a metric, `read(readings)`, which returns
  a number or None (nothing to read: the metric is left out of the line).

A run: set-up (the traffic module builds the program from seeded weights, warms up
every shape the mix uses and takes the readings its check needs), then the
measured window: the traffic module's `step()` dispatched back to back in a closed
loop, at most QUEUE_DEPTH steps ahead of the device (the host waits on the
CUDA event of an older step, never drains the queue), a CUDA event recorded
at each step's end, until `--seconds` have passed on the host clock, then one
synchronise. With --trace 1 the same window runs with the traffic module's spans on,
then a few steps under torch.profiler recording the device alone (busy and
wall seconds: `device`'s busy_s and window_s, and idle_share), then as many
under torch.profiler recording host and device (sub-path ranges from
spans.py: kernel_roofline and the breakdown), then the host clock around
single steps after a synchronise. Then the program's state is freed and the
traffic module's check runs the reference.

The last line of standard output is the result; the numbers compared, each
beside its limit, are the last lines of standard error and the last key of
the result.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tvts_tpu")
QUEUE_DEPTH = 3
PROFILE_SECONDS = 1.5  # device time the profiled steps cover, at least PROFILE_MIN_STEPS
PROFILE_MIN_STEPS = 3
# sessions of torch.profiler that may record no device activity before the
# profile is given up (seen on the card now and then, ten in a row once); the
# waits between them double from 0.5 s up to 8 s, each after emptying the cache
PROFILE_ATTEMPTS = 10
HOST_CALLS = 5
BREAKDOWN_TOP = 10


def forbidden_modules() -> list[str]:
    """Top-level names in sys.modules that belong to JAX or the JAX package,
    compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_file(path: Path, name: str):
    """The module at `path`, under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of the spec's `workloads` with its configuration, traffic mix,
    limits and metrics."""

    def __init__(self, spec: dict, name: str, bench_dir: Path = BENCH_DIR, root: Path = ROOT):
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in the spec: {sorted(entries)}")
        entry = entries[name]
        self.name, self.chips = name, entry["chips"]
        config = {c["name"]: c for c in spec["configs"]}[entry["config"]]
        self.config = json.loads((root / config["file"]).read_text())
        self.traffic = json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text())
        self.limits = json.loads((bench_dir / "limits" / f"{name}.json").read_text())
        self.driver_path = bench_dir / "traffic" / f"{self.traffic['kind']}.py"
        self.metrics_dir = bench_dir / "metrics"
        self.end_to_end = [m for m in spec["end_to_end"] if reports(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if reports(m, name)]

    def driver(self):
        return load_file(self.driver_path, f"bench_traffic_{self.traffic['kind']}")


class _HostEvent:
    """A CUDA event's interface on the host clock (CPU runs: the tests)."""

    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, other: "_HostEvent") -> float:
        return (other.t - self.t) * 1e3


class Device:
    """Events, synchronisation and memory readings of the device a run uses."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def event(self):
        if not self.cuda:
            return _HostEvent()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def reset_peak(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def describe(self, chips: int) -> dict:
        kind = torch.cuda.get_device_name(self.device) if self.cuda else "cpu"
        return {"platform": "gpu" if self.cuda else "cpu", "kind": kind, "count": chips}


class Window:
    """What a measured window dispatched: each step's traffic-module record and its
    time between CUDA events, and the host seconds from the start to the
    final synchronise."""

    def __init__(self, steps: list, step_ms: list, seconds: float):
        self.steps, self.step_ms, self.seconds = steps, step_ms, seconds

    @property
    def clips(self) -> int:
        return sum(s["clips"] for s in self.steps)

    @property
    def flops(self) -> float:
        return sum(s["flops"] for s in self.steps)


def measure(session, dev: Device, seconds: float = 0.0, steps: int | None = None) -> Window:
    """Dispatch session.step() back to back for `seconds` (or `steps` steps)."""
    dev.sync()
    start = dev.event()
    t0 = time.perf_counter()
    ends, records = [], []
    while True:
        if len(ends) >= QUEUE_DEPTH:
            ends[-QUEUE_DEPTH].synchronize()
        records.append(session.step())
        ends.append(dev.event())
        if (len(records) >= steps) if steps is not None else (time.perf_counter() - t0 >= seconds):
            break
    dev.sync()
    elapsed = time.perf_counter() - t0
    marks = [start] + ends
    return Window(records, [a.elapsed_time(b) for a, b in zip(marks, marks[1:])], elapsed)


class Readings:
    """What the metric readers read: the cell, the window (trace 0: the
    measured window; trace 1: the same window run with the spans on), set-up
    seconds and peak memory, the traffic module's spans (name -> ms each), the
    profile (device and host, with the sub-path ranges), the host-clock
    samples and the device-only profile's busy and wall seconds."""

    def __init__(self, cell: Cell, window: Window, setup_s: float, window_peak: int,
                 spans: dict | None = None, profile: dict | None = None,
                 host_ms: list | None = None, busy: dict | None = None):
        self.cell, self.window, self.setup_s = cell, window, setup_s
        self.window_peak = window_peak
        self.spans = spans or {}
        self.profile = profile
        self.host_ms = host_ms or []
        self.busy = busy


def percentile(values: list, q: float) -> float:
    """The q-th percentile (linear between closest ranks, as numpy's default)."""
    ordered = sorted(values)
    pos = (len(ordered) - 1) * q / 100
    lo = math.floor(pos)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo)


def read_metrics(cell: Cell, entries: list, readings: Readings) -> dict:
    out = {}
    for entry in entries:
        name = entry["name"]
        reader = load_file(cell.metrics_dir / f"{name}.py", f"bench_metric_{name}")
        value = reader.read(readings)
        if value is not None:
            out[name] = {"value": value, "unit": entry["unit"]}
    return out


# ---------------------------------------------------------------------------
# the profiled steps
# ---------------------------------------------------------------------------
def _union_us(intervals: list) -> tuple[float, list]:
    """(covered microseconds, merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def parse_profile(prof, calls: list) -> dict | None:
    """Device kernels, idle gaps and each sub-path call's (entry, device ms,
    bound ms) from one torch.profiler session; None when it recorded no
    device activity. "calls_complete" is false where a call's kernels were
    lost."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    host = [e for e in events if e.device_type != DeviceType.CUDA]
    host_names = {e.name for e in host}
    kernels = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                     if e.device_type == DeviceType.CUDA and e.name not in host_names)
    if not kernels:
        return None
    # a sub-path call's device time: the kernels inside its range on the device
    # timeline (the host range's own device total misses most of them)
    starts = [s for s, _, _ in kernels]
    by_call = {}
    for e in events:
        if e.device_type == DeviceType.CUDA and e.name.startswith("bench::"):
            lo = bisect.bisect_left(starts, e.time_range.start)
            hi = bisect.bisect_left(starts, e.time_range.end)
            by_call[e.name] = sum(ke - ks for ks, ke, _ in kernels[lo:hi])
    timed = [(entry_of(name), by_call.get(name, 0.0) / 1e3, bound) for name, bound in calls]
    _, merged = _union_us([(s, e) for s, e, _ in kernels])
    by_name: dict = {}
    for s, e, name in kernels:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(merged, merged[1:])), reverse=True)
    idle = [[_host_doing(host, (s + e) / 2), g / 1e6] for g, s, e in gaps[:BREAKDOWN_TOP]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
    return {"calls": timed,
            "calls_complete": all(ms > 0 for _, ms, _ in timed),
            "device_ops": [[name, us / 1e6] for name, us in top], "idle_gaps": idle}


def entry_of(label: str) -> str:
    """The sub-path entry of a range name "bench::<entry>#<n>"."""
    return label[len("bench::"):].rsplit("#", 1)[0]


def device_busy(session, dev: Device, n_steps: int) -> dict | None:
    """n_steps of the session under torch.profiler recording the device
    alone (no host activity, which slows the host and so widens the gaps):
    the union of the device's activity intervals ("busy_s") over the
    session's own wall seconds from a synchronise to a synchronise
    ("window_s"). Retried as PROFILE_ATTEMPTS says; None when no session
    recorded device activity (or there is no device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not dev.cuda:
        return None
    for attempt in range(PROFILE_ATTEMPTS):
        dev.sync()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiled = measure(session, dev, steps=n_steps)
        busy = [(e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)]
        if busy:
            return {"busy_s": _union_us(busy)[0] / 1e6, "window_s": profiled.seconds}
        print(f"torch.profiler (device only): session {attempt + 1} recorded no device activity",
              file=sys.stderr)
        torch.cuda.empty_cache()
        time.sleep(min(8.0, 0.5 * 2 ** attempt))
    return None


def _host_doing(host: list, t: float) -> str:
    """The innermost host range running at time t (what the host was doing
    while the device waited)."""
    covering = [e for e in host if e.time_range.start <= t <= e.time_range.end]
    if not covering:
        return "no host range"
    inner = min(covering, key=lambda e: e.time_range.end - e.time_range.start)
    return inner.name


def profile_steps(session, dev: Device, n_steps: int) -> dict | None:
    """n_steps of the session under torch.profiler with the sub-path ranges
    on; retried as PROFILE_ATTEMPTS says. None when no session recorded
    device activity; without the calls where each lost some."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import spans

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.cuda else [])
    partial = None
    for attempt in range(PROFILE_ATTEMPTS):
        dev.sync()
        with spans.subpath_ranges() as calls, profile(activities=activities) as prof:
            measure(session, dev, steps=n_steps)
        parsed = parse_profile(prof, calls)
        if parsed is not None and parsed["calls_complete"]:
            return parsed
        partial = parsed or partial
        print(f"torch.profiler: session {attempt + 1} "
              f"{'lost sub-path kernels' if parsed else 'recorded no device activity'}",
              file=sys.stderr)
        if dev.cuda:
            torch.cuda.empty_cache()
        time.sleep(min(8.0, 0.5 * 2 ** attempt))
    if partial is not None:  # device activity without every call: no call is timed
        partial["calls"] = []
    return partial


def host_samples(session, dev: Device, n: int = HOST_CALLS) -> list[float]:
    """Host ms of single steps, each after a synchronise (the queue drained)."""
    out = []
    for _ in range(n):
        dev.sync()
        t0 = time.perf_counter()
        session.step()
        out.append((time.perf_counter() - t0) * 1e3)
    dev.sync()
    return out


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of `cell` (module notes); the result dict, checks last."""
    dev = Device(device)
    session = cell.driver().Session(cell, seed, dev)
    session.set_up()
    dev.sync()
    setup_s = time.perf_counter() - t_start
    t_window = time.perf_counter()
    setup_peak = dev.peak()
    dev.reset_peak()
    session.begin_window()
    if not trace:
        window = measure(session, dev, seconds)
        window_peak = dev.peak()
        readings = Readings(cell, window, setup_s, window_peak)
        metrics = read_metrics(cell, cell.end_to_end, readings)
        extra = {}
    else:
        session.spans_on(True)
        window = measure(session, dev, seconds)
        window_peak = dev.peak()
        spans = session.spans_on(False)
        median_ms = statistics.median(window.step_ms)
        n = max(PROFILE_MIN_STEPS, math.ceil(PROFILE_SECONDS * 1e3 / max(median_ms, 1e-3)))
        n += n % 2  # whole rounds of a two-loader round robin
        busy = device_busy(session, dev, n)
        prof = profile_steps(session, dev, n)
        readings = Readings(cell, window, setup_s, window_peak, spans, prof,
                            host_samples(session, dev), busy)
        metrics = read_metrics(cell, cell.per_layer, readings)
        extra = {}
        if busy is not None:
            extra = {"busy_s": busy["busy_s"], "window_s": busy["window_s"]}
    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package were loaded: {bad}")
    failed = session.failures()
    device_info = dict(dev.describe(cell.chips),
                       memory_peak_bytes=max(setup_peak, window_peak, dev.peak()), **extra)
    session.release()
    gc.collect()
    if dev.cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = session.check()
    print(f"timing: set-up {setup_s:.2f} s, window and readings {t_check - t_window:.2f} s, "
          f"check {time.perf_counter() - t_check:.2f} s", file=sys.stderr)
    correct = failed == 0 and all(value <= limit for _, value, limit in checks)
    result = {"correct": correct, "attempted": len(window.steps), "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace and readings.profile is not None:
        result["breakdown"] = {"device_ops": readings.profile["device_ops"],
                               "idle_gaps": readings.profile["idle_gaps"]}
    result["checks"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    parser = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = Cell(spec, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found {found}", file=sys.stderr)
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
