"""Batch grouping and the host-to-device infeed: the one-device part of
``distributed_tensorflow_examples_tpu/data/pipeline.py``.

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
