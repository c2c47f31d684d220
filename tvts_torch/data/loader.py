"""Sharded, prefetching batch loader (counterpart of tvts_tpu/data/loader.py).

The reference's `MultiDistBaseDataLoaderExplicitSplit`
(v2/base/base_data_loader.py:117-138): each process takes its own slice of
the (epoch-seeded, shuffled) indices, world size replicas, drop_last. The
rank and world size come from the arguments, else from torch.distributed
where a process group is initialised, else 0 and 1. Batches are numpy arrays.

Collation is torch's default collate for the shapes used here: arrays stack
along a new batch axis; a per-sample list of strings turns clip-major
([clip][batch]), which is what the reference trainer's text concatenation
expects (trainer.py:465-472).

Scheduling: the JAX package makes a whole batch one worker's task. Here an
item is a task, for the threads and for the fork pool alike, with up to
`prefetch` batches' worth of items in flight, and each batch is collated from
its items in index order: the batches hold the items of `num_workers=0` in
the same order (an item that draws from Python's shared `random` state
draws what the scheduling hands it, as across batches in both packages).
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import itertools
import multiprocessing as mp
import os
import random

import numpy as np

# seconds the fork pool waits for one item: a worker that crashed (its task
# lost) or deadlocked raises here instead of hanging the consumer
PROC_ITEM_TIMEOUT_S = 600


def default_collate(samples: list[dict]) -> dict:
    batch: dict = {}
    first = samples[0]
    for key, val in first.items():
        vals = [s[key] for s in samples]
        if isinstance(val, np.ndarray):
            batch[key] = np.stack(vals)
        elif isinstance(val, (int, np.integer)):
            batch[key] = np.asarray(vals)
        elif isinstance(val, (list, tuple)) and val and isinstance(val[0], str):
            # a per-sample list of n strings -> clip-major [clip][batch]
            batch[key] = [[v[c] for v in vals] for c in range(len(val))]
        else:  # strings, meta dicts and the rest: a list over the batch
            batch[key] = vals
    return batch


class SubsetDataset:
    """Index-subset view of a dataset (for random train / val splits)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i % len(self.indices)])]

    def __getattr__(self, name):  # dataset_name and the rest pass through
        return getattr(self.dataset, name)


def make_val_split(dataset, val_fraction: float = 0.1, seed: int = 0):
    """Random train / val split of one dataset (the reference BaseDataLoader's
    validation_split, base_data_loader.py:8-68). Returns (train_ds, val_ds)."""
    n = len(dataset)
    n_val = int(n * val_fraction) if val_fraction < 1 else int(val_fraction)
    idx = np.random.default_rng(seed).permutation(n)
    return SubsetDataset(dataset, idx[n_val:]), SubsetDataset(dataset, idx[:n_val])


def _distributed_rank() -> tuple[int, int]:
    """(rank, world size) of torch.distributed's default group, or (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedLoader:
    def __init__(self,
                 dataset,
                 batch_size: int,
                 shuffle: bool = True,
                 drop_last: bool = True,
                 num_workers: int = 8,
                 seed: int = 0,
                 process_index: int | None = None,
                 num_processes: int | None = None,
                 collate=default_collate,
                 prefetch: int = 2,
                 use_processes: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.collate = collate
        self.prefetch = prefetch
        self.use_processes = use_processes
        self.epoch = 0
        if process_index is None or num_processes is None:
            process_index, num_processes = _distributed_rank()
        self.process_index = process_index
        self.num_processes = num_processes

    @property
    def n_samples(self) -> int:
        return len(self.dataset)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _local_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            idx = np.random.default_rng((self.seed, self.epoch)).permutation(n)
        else:
            idx = np.arange(n)
        per_proc = n // self.num_processes
        if per_proc == 0:
            return idx  # fewer samples than processes: every process sees them all
        idx = idx[: per_proc * self.num_processes]
        return idx[self.process_index:: self.num_processes]

    def __len__(self) -> int:
        local = len(self.dataset) // max(1, self.num_processes)
        if self.drop_last:
            return local // self.batch_size
        return (local + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = self._local_indices()
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size] for i in range(len(self))]
        if not batches:
            return
        if self.num_workers <= 0:
            for b in batches:
                yield self.collate([self.dataset[int(i)] for i in b])
            return
        if self.use_processes:
            yield from self._iter_processes(batches)
            return
        with cf.ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            yield from self._pipelined(batches, lambda i: pool.submit(self.dataset.__getitem__, i),
                                       cf.Future.result)

    def _pipelined(self, batches, submit, result):
        """The collated batches, from items submitted one a task in index
        order, at most `prefetch` batches' worth of them in flight: each item
        taken frees a slot for the next."""
        items = (int(i) for b in batches for i in b)
        pending = collections.deque(
            submit(i) for i in itertools.islice(items, max(1, self.prefetch) * self.batch_size))
        for b in batches:
            samples = []
            for _ in range(len(b)):
                samples.append(result(pending.popleft()))
                i = next(items, None)
                if i is not None:
                    pending.append(submit(i))
            yield self.collate(samples)

    def _iter_processes(self, batches):
        """A pool of forked worker processes (the JAX package's, for decode and
        transforms that hold the interpreter lock): workers inherit the dataset,
        a task is an item, collation stays here. A worker touches nothing of
        the parent but the dataset (no CUDA, no torch)."""
        ctx = mp.get_context("fork")
        with ctx.Pool(processes=self.num_workers, initializer=_proc_init,
                      initargs=(self.dataset,)) as pool:
            yield from self._pipelined(
                batches, lambda i: pool.apply_async(_proc_item, (i,)),
                lambda r: r.get(timeout=PROC_ITEM_TIMEOUT_S))


_PROC_DATASET = None


def _proc_init(dataset):
    global _PROC_DATASET
    _PROC_DATASET = dataset
    # forked workers inherit one random state: reseed each, so the items'
    # augmentation streams differ
    random.seed(int.from_bytes(os.urandom(8), "little"))
    np.random.seed(int.from_bytes(os.urandom(4), "little"))


def _proc_item(i):
    return _PROC_DATASET[i]
