"""Prefetching data loader with per-process sharding and deterministic
randomness (port of human_pose_tpu/data/loader.py; host side, no torch).

A thread pool decodes and augments samples ahead of the training loop (cv2,
NumPy and the native splat release the GIL for their heavy work) while the
card computes, and an epoch-seeded permutation is sharded across processes.

Determinism: each sample gets its own ``np.random.Generator`` seeded by
(seed, epoch, dataset index), passed into ``dataset.__getitem__``, so the
batch stream is the same from run to run whatever the thread schedule and
the process layout, and equals the JAX package's for the same dataset.
Resume state is (seed, epoch).
"""

from __future__ import annotations

import inspect
import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Full, Queue
from typing import Callable, Iterator

import numpy as np


class _ProducerError:
    """Wraps an exception raised in the producer thread so the consuming
    loop re-raises it instead of hanging on a queue that will never fill."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        collate_fn: Callable,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0
        self._getitem_takes_rng = (
            "rng" in inspect.signature(dataset.__getitem__).parameters
        )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if n == 0:
            return np.arange(0)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # shard across processes (DistributedSampler equivalent): pad to a
        # multiple so every process sees the same number of batches; cycle
        # the permutation so shards stay equal even when n < process_count.
        # Sharding is BLOCK-per-global-batch, not interleaved: process p takes
        # the p-th contiguous slice of every global batch of the canonical
        # (seed, epoch) stream, so the processes' batches put together in
        # rank order are IDENTICAL (same samples, same order) to what a
        # single process would load — the global batch stream is invariant
        # to process topology, which torch's interleaved DistributedSampler
        # (reference datamodule.py:68-89) does not guarantee.
        total = -(-n // self.process_count) * self.process_count
        padded = np.tile(order, -(-total // n))[:total]
        if self.process_count == 1:
            return padded
        gb = self.batch_size * self.process_count
        out = []
        for pos in range(0, total, gb):
            chunk = padded[pos : pos + gb]  # tail chunk stays P-divisible
            lb = len(chunk) // self.process_count
            out.append(chunk[self.process_index * lb : (self.process_index + 1) * lb])
        return np.concatenate(out)

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _get_sample(self, idx: int):
        """Fetch one sample with its own (seed, epoch, idx)-derived generator:
        reproducible regardless of thread scheduling or shard layout."""
        idx = int(idx)
        if not self._getitem_takes_rng:
            return self.dataset[idx]
        rng = np.random.default_rng((self.seed, self.epoch, idx))
        return self.dataset.__getitem__(idx, rng)

    def __iter__(self) -> Iterator:
        indices = self._epoch_indices()
        nb = len(self)
        batches = [
            indices[i * self.batch_size : (i + 1) * self.batch_size] for i in range(nb)
        ]
        q: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded put so a consumer that exits early (limit_batches,
            # sanity check) can always unblock us via `stop` — a plain
            # q.put() would leak this thread and its pool every interrupted
            # epoch, parked forever on a full queue
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self._get_sample, batch_idx))
                        if not put(self.collate_fn(samples)):
                            return
                put(None)
            except BaseException as e:  # surface in the training loop, don't hang it
                put(_ProducerError(e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            # drain so a producer mid-put sees `stop` promptly
            while True:
                try:
                    q.get_nowait()
                except Empty:
                    break

    # -- resumable state (reference datamodule.py:91-106) --------------------
    # every random draw is a pure function of (seed, epoch, index), so resume
    # state is just these two scalars — no RNG snapshot needed
    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "seed": self.seed}

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state["epoch"])
        if "seed" in state:
            self.seed = int(state["seed"])
