"""Host -> device prefetching (counterpart of tvts_tpu/data/prefetch.py:16).

Overlaps the host's batch preparation (decode, transform, tokenize, collate)
with the device's step by keeping `size` batches in flight on the device: the
reference DataLoader's pin_memory + non_blocking copies.

The default `put` on CUDA copies every array leaf of a batch into pinned host
memory, then to the device with non_blocking=True on a side stream, and
records an event there; the consumer's stream waits on that event before the
batch is yielded, so the step never reads a batch whose copy is in flight.
Each device tensor is marked as used by the consumer's stream
(`record_stream`), so the caching allocator does not hand its memory to the
side stream's next copy while the step may still read it; each pinned source
is held until the consumer's stream has waited on its copy. Leaves that are
not numeric arrays (strings, lists of strings, meta dicts) pass through as
they are. There is no fallback to the CPU: without CUDA the default device
raises, and the CPU path is asked for by name (`device="cpu"`, which turns
the arrays into CPU tensors).
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch


def _map_arrays(fn, tree):
    """tree with fn applied to every numeric numpy array and CPU tensor leaf."""
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_arrays(fn, v) for v in tree)
    if isinstance(tree, np.ndarray) and tree.dtype.kind in "biuf":
        return fn(torch.from_numpy(np.ascontiguousarray(tree)))
    if isinstance(tree, torch.Tensor) and tree.device.type == "cpu":
        return fn(tree)
    return tree


class _CudaPut:
    """put(batch) -> (device batch, the copies' event, the pinned sources)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)

    def __call__(self, batch):
        consumer = torch.cuda.current_stream(self.device)
        sources = []

        def copy(host: torch.Tensor) -> torch.Tensor:
            pinned = host.pin_memory()
            sources.append(pinned)
            with torch.cuda.stream(self.stream):
                out = pinned.to(self.device, non_blocking=True)
            out.record_stream(consumer)
            return out

        out = _map_arrays(copy, batch)
        event = torch.cuda.Event()
        event.record(self.stream)
        return out, event, sources


def prefetch_to_device(iterator: Iterable, size: int = 2, put: Callable | None = None,
                       device=None) -> Iterator:
    """Yield the batches of `iterator` on the device, keeping `size` in flight.

    `device` defaults to "cuda" (RuntimeError here, at the call, where CUDA
    is not available); "cpu" gives the batches with CPU tensors for their
    arrays. `put` replaces the default placement: put(batch) is yielded as it
    returns."""
    if size < 1:
        raise ValueError(f"prefetch_to_device: size {size}, at least 1 batch must be in flight")
    device = torch.device("cuda" if device is None else device)
    wait = None
    if put is None:
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("prefetch_to_device: no CUDA device; pass device='cpu' to "
                                   "prefetch into CPU tensors")
            put = _CudaPut(device)

            def wait(entry):
                out, event, _ = entry
                torch.cuda.current_stream(device).wait_event(event)
                return out
        elif device.type == "cpu":
            put = lambda batch: _map_arrays(lambda t: t, batch)  # noqa: E731
        else:
            raise ValueError(f"prefetch_to_device: no placement for device {device}")
    return _prefetch(iter(iterator), size, put, wait)


def _prefetch(it: Iterator, size: int, put: Callable, wait: Callable | None) -> Iterator:
    queue = collections.deque()
    for batch in it:
        queue.append(put(batch))
        if len(queue) >= size:
            break
    while queue:
        out = queue.popleft()
        for batch in it:
            queue.append(put(batch))
            break
        yield wait(out) if wait else out
