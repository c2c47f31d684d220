"""Timeline profiling and the program's spans (counterpart of
tvts_tpu/utils/profiling.py; the reference has no profiler).

- Spans: each layer boundary of the paths users run is a span named
  `tvts::<name>`, opened by `annotate(name, like)` around a block of code or
  by the `spanned(name)` decorator around an entry function (an autograd
  Function's `backward` too, under its `@staticmethod`). Spans are off by
  default, and then a span costs one check of a module global.
  `spans_on(True)` turns them on. Each span then opens a
  torch.profiler range (on the profiler's clock, which Kineto aligns with the
  device activity it records, so a trace shows each kernel and each idle
  gap under the span that enqueued it) and an NVTX range where CUDA is
  present, and keeps in memory, per name: its calls, each call's host ms,
  its device ms (CUDA events at its edges on the current stream, where its
  tensor `like` is on the card: in steady state, with the queue full, the
  device's time for the span's work, which a profiler's host activity would
  distort), its geometry and the spans it ran under (a thread-local stack; a
  span on a thread with none open, as the autograd engine's device threads
  are, ran under the span open on the thread that turned spans on).
  `take_spans()` waits for the events and returns the records, clearing them.
- Geometry: a dict of what a call's work depends on: B, S and D of its first
  tensor where that is [B, S, D] (else its shape), each scalar argument by
  name, defaults included, and what an entry adds (an MLP's hidden width,
  whether its hidden activation is saved). It is also the range's `args`
  string, which torch.profiler keeps only under `record_shapes`.
- The host-sync count: while spans are on, CUDA is present and CUDA's sync
  debug mode is at its default, the mode warns at each synchronising call
  (`.item()`, `.cpu()`, `nonzero`, a copy to the host); each warning raised
  inside a span counts under the innermost span, and every such warning is
  swallowed, so standard error stays the caller's. A mode the caller set
  ("warn" or "error") is left as it is, and nothing is counted. A
  synchronising call that the autograd engine makes in C++ is re-emitted on
  the calling thread when `backward()` returns: it counts under the span
  open there (`backward` in a train step).
- `trace(log_dir)`: torch.profiler over the CPU and, where CUDA is present,
  the card, with the spans on (the state before restored after), its chrome
  trace written into `log_dir`; where the trace turned the spans on, their
  records of its window (`take_spans()`) go beside it as JSON
  (`*.spans.json`; `trace_artifacts` lists either kind). The JAX package
  swallows a profiler that cannot start; here its error propagates.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import inspect
import json
import os
import socket
import threading
import time
import warnings

import torch

SYNC_WARNING = "called a synchronizing CUDA operation"
SPANS_SUFFIX = ".spans.json"

_on = False
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()
_owner_stack: list = []  # the stack of the thread that turned spans on
_records: dict = {}
_syncs: dict | None = None  # span name -> synchronising calls, while the counter is armed
_armed = None  # (showwarning, filter) to restore when spans go off
_nvtx = False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _innermost() -> str | None:
    stack = _stack() or _owner_stack
    return stack[-1] if stack else None


def describe(x: torch.Tensor | None = None, **fields) -> dict:
    """A span's geometry (module notes): B, S and D of a [B, S, D] tensor,
    else its shape, then `fields`."""
    out = {}
    if x is not None:
        out = dict(zip("BSD", x.shape)) if x.dim() == 3 else {"shape": list(x.shape)}
    return {**out, **fields}


class _Span:
    __slots__ = ("name", "geometry", "stream", "parent", "nvtx", "range", "start", "t0")

    def __init__(self, name: str, like=None, geometry: dict | None = None):
        self.name, self.geometry = name, geometry
        self.stream = (torch.cuda.current_stream(like.device)
                       if isinstance(like, torch.Tensor) and like.is_cuda else None)

    def __enter__(self):
        self.parent = _innermost()
        _stack().append(self.name)
        label = "tvts::" + self.name
        args = (" ".join(f"{k}={v}" for k, v in self.geometry.items())
                if self.geometry else None)
        self.range = torch.profiler.record_function(label, args)
        self.range.__enter__()
        self.nvtx = _nvtx
        if self.nvtx:
            torch.cuda.nvtx.range_push(label)
        self.start = None
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        host_ms = (time.perf_counter_ns() - self.t0) / 1e6
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        self.range.__exit__(*exc)
        _stack().pop()
        with _lock:
            rec = _records.get(self.name)
            if rec is None:
                rec = _records[self.name] = {"calls": 0, "host_ms": [], "device_ms": [],
                                             "geometry": [], "parents": {}, "events": []}
            rec["calls"] += 1
            rec["host_ms"].append(host_ms)
            rec["geometry"].append(self.geometry)
            rec["parents"][self.parent] = rec["parents"].get(self.parent, 0) + 1
            if end is not None:
                rec["events"].append((self.start, end))
        return False


def annotate(name: str, like: torch.Tensor | None = None):
    """The span `name` around a block of code (module notes); `like`: a
    tensor of the work, whose stream the span's device time is taken on."""
    if not _on:
        return _OFF
    return _Span(name, like)


def spanned(name: str, geometry=None):
    """Decorator: each call of the function runs inside the span `name`,
    timed on the device of its first tensor argument. `geometry(*args,
    **kwargs)` gives the call's geometry (by default `describe` of the first
    tensor and every scalar argument by its name, defaults included),
    computed only while spans are on. The wrapper's `span` attribute is
    `name`."""
    def wrap(fn):
        signature = inspect.signature(fn)

        def default(*args, **kwargs):
            bound = signature.bind(*args, **kwargs)
            bound.apply_defaults()
            named = bound.arguments.items()
            first = next((v for _, v in named if isinstance(v, torch.Tensor)), None)
            return describe(first, **{k: v for k, v in named
                                      if isinstance(v, (bool, int, float, str))})

        geometry_of = geometry or default

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            like = next((v for v in (*args, *kwargs.values()) if isinstance(v, torch.Tensor)),
                        None)
            with _Span(name, like, geometry_of(*args, **kwargs)):
                return fn(*args, **kwargs)

        call.span = name
        return call
    return wrap


def _show(message, category, filename, lineno, file=None, line=None):
    """warnings.showwarning while the counter is armed: a sync warning counts
    under the innermost span (none outside one) and is swallowed."""
    if SYNC_WARNING in str(message):
        name = _innermost()
        with _lock:
            if name is not None and _syncs is not None:
                _syncs[name] = _syncs.get(name, 0) + 1
        return
    show = _armed[0] if _armed is not None else warnings._showwarning_orig
    show(message, category, filename, lineno, file, line)


def _arm() -> None:
    """Count the synchronising calls, where the caller left CUDA's sync debug
    mode at its default (module notes)."""
    global _armed, _syncs
    if torch.cuda.get_sync_debug_mode() != 0:
        return
    with warnings.catch_warnings():  # torch's note that the mode is a prototype
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
    show = warnings.showwarning
    warnings.filterwarnings("always", message=SYNC_WARNING)  # counted at every call, not once
    _armed = (warnings._showwarning_orig if show is _show else show, warnings.filters[0])
    _syncs = {}
    warnings.showwarning = _show


def _disarm() -> None:
    global _armed
    show, entry = _armed
    torch.cuda.set_sync_debug_mode(0)
    if warnings.showwarning is _show:
        warnings.showwarning = show
    if entry in warnings.filters:
        warnings.filters.remove(entry)
        warnings._filters_mutated()  # drop what the registries cached under it
    _armed = None


def spans_on(on: bool) -> bool:
    """Turn the spans (and, where CUDA is present, the host-sync count) on
    or off; returns the state before."""
    global _on, _owner_stack, _nvtx
    was = _on
    if on and not was:
        _owner_stack = _stack()
        _nvtx = torch.cuda.is_available()
        if _nvtx:
            _arm()
        _on = True
    elif was and not on:
        _on = False
        if _armed is not None:
            _disarm()
    return was


def take_spans() -> dict:
    """The spans recorded since the last call, cleared: {"spans": {name:
    {"calls", then a list a call of "host_ms", "device_ms" (empty off the
    card) and "geometry", and "parents" (parent name, None at the top ->
    calls)}}, and where the counter was armed "host_syncs": {"total",
    "by_span": {name: count}}}. Waits for the spans' CUDA events."""
    global _syncs
    with _lock:
        records = dict(_records)
        _records.clear()
        syncs = _syncs
        if syncs is not None:
            _syncs = {} if _armed is not None else None
    for rec in records.values():
        for start, end in rec.pop("events"):
            end.synchronize()
            rec["device_ms"].append(start.elapsed_time(end))
    out = {"spans": records}
    if syncs is not None:
        out["host_syncs"] = {"total": sum(syncs.values()), "by_span": syncs}
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region into ``log_dir`` (a chrome trace,
    `*.pt.trace.json`, which TensorBoard's profiler plugin and
    chrome://tracing read), with the spans on; where this turned them on,
    their records beside it (module notes). Yields the
    torch.profiler.profile object."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    was = spans_on(True)
    try:
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
            yield prof
    finally:
        spans_on(was)
        if not was:  # the records are the trace's alone: written beside it
            name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}{SPANS_SUFFIX}"
            with open(os.path.join(log_dir, name), "w") as f:
                json.dump(take_spans(), f)


def trace_artifacts(log_dir: str, suffix: str = ".pt.trace.json") -> list[str]:
    """The trace files under ``log_dir`` (`SPANS_SUFFIX`: the span records),
    newest first."""
    return sorted(glob.glob(os.path.join(log_dir, "*" + suffix)), key=os.path.getmtime,
                  reverse=True)
