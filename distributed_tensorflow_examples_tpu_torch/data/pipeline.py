"""Batching, batch grouping and the host-to-device infeed: the one-process
part of ``distributed_tensorflow_examples_tpu/data/pipeline.py``.

:class:`InMemoryPipeline` gives the JAX pipeline's batches for the same
seed on one process: epoch e's order is
``default_rng((seed, e)).permutation(n)``.

:func:`prefetch_to_device` takes ``prefetch_to_mesh``'s role: a
background thread keeps ``depth`` batches queued, each field copied from
pinned host memory with ``non_blocking=True``, so the host-to-device copy
overlaps the previous step's compute.  On the CPU the batch is handed
over as it is.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch


class InMemoryPipeline:
    """Shuffled, infinitely repeating batch stream over in-memory numpy
    arrays (one process: every batch is ``batch_size`` rows; the ragged
    end of an epoch is dropped)."""

    def __init__(self, arrays: dict[str, np.ndarray], *, batch_size: int, seed: int = 0):
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"mismatched field lengths {lengths}")
        self.fields = dict(arrays)
        self.n = next(iter(lengths.values()))
        if not 0 < batch_size <= self.n:
            raise ValueError(f"batch_size {batch_size} must be in [1, {self.n}]")
        self.batch_size = batch_size
        self.seed = seed

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        epoch = 0
        while True:
            order = np.random.default_rng((self.seed, epoch)).permutation(self.n)
            for s in range(self.n // self.batch_size):
                idx = order[s * self.batch_size : (s + 1) * self.batch_size]
                yield {k: v[idx] for k, v in self.fields.items()}
            epoch += 1


def to_device(batch: dict, device) -> dict[str, torch.Tensor]:
    """A dict of numpy arrays as tensors on ``device`` (pinned staging and
    a non-blocking copy on CUDA)."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch_to_device(
    it: Iterable[dict[str, np.ndarray]], device, *, depth: int = 2
) -> Iterator[dict[str, torch.Tensor]]:
    """Background-thread infeed: keeps ``depth`` device batches queued
    ahead of the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()

    def _producer():
        try:
            for batch in it:
                if stop.is_set():
                    return
                q.put(to_device(batch, device))
        except Exception as e:  # surface producer errors at the consumer
            q.put(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=_producer, daemon=True, name="infeed-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        # Drain so the producer's blocked put() can observe stop and exit.
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def stack_for_unroll(
    it: Iterator[dict[str, np.ndarray]], k: int
) -> Iterator[dict[str, np.ndarray]]:
    """Group k consecutive batches into one [k, ...] super-batch for
    multi-step-unrolled train steps."""
    while True:
        group = [next(it) for _ in range(k)]
        yield {key: np.stack([g[key] for g in group]) for key in group[0]}
