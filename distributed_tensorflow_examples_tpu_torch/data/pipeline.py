"""Batching, the per-rank shard and the host-to-device infeed: the port
of ``distributed_tensorflow_examples_tpu/data/pipeline.py``.

:class:`InMemoryPipeline` gives each rank exactly the rows the JAX
pipeline gives that process for the same seed: epoch e's order is
``default_rng((seed, e)).permutation(n)``, truncated to a multiple of the
rank count, and rank r takes every ``count``-th entry from r (strided,
not contiguous), ``batch_size / count`` rows a batch.  JAX's
``as_global`` lays those local batches out as one global batch, rank
0's rows first; the port's ranks keep theirs (``parallel/sharding.py``).
Under gradient accumulation over several ranks (``microbatches=k``) the
JAX step cuts that GLOBAL batch into k microbatches, so a microbatch spans
the ranks' rows: each rank then yields its share of every microbatch
(``sharding.microbatch_rows``), taken from the epoch order every rank
computes anyway, with no rows exchanged.  :func:`rank_batches` does the
same for any per-rank stream (the LM CLIs' blocks, word2vec's seeds),
and :func:`seq_columns` cuts a rank's slice of the sequence out of each
of its batches (the transformer's ``seq`` axis; the x/y shift is already
in the batch, so no token crosses a shard).

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

from ..parallel import collectives, sharding


class InMemoryPipeline:
    """Shuffled, sharded, infinitely repeating batch stream over in-memory
    numpy arrays.  ``batch_size`` is the GLOBAL batch; this rank yields
    ``batch_size // process_count`` rows a batch (``process_index`` and
    ``process_count`` default to the ``data`` axis: the rank's data index
    and the data size, so the model ranks of one data index read the same
    rows; without a mesh, the world's rank and size); the ragged
    end of an epoch is dropped.  ``microbatches=k`` (``--grad_accum``):
    on several ranks, this rank's share of each of the k microbatches of
    the global batch, microbatch 0's rows first (module docstring)."""

    def __init__(
        self,
        arrays: dict[str, np.ndarray],
        *,
        batch_size: int,
        seed: int = 0,
        process_index: int | None = None,
        process_count: int | None = None,
        microbatches: int = 1,
    ):
        lengths = {k: len(v) for k, v in arrays.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"mismatched field lengths {lengths}")
        self.fields = dict(arrays)
        self.n = next(iter(lengths.values()))
        if not 0 < batch_size <= self.n:
            raise ValueError(f"batch_size {batch_size} must be in [1, {self.n}]")
        self.pidx = (collectives.axis_index(sharding.ROWS) if process_index is None
                     else process_index)
        self.pcount = (collectives.axis_size(sharding.ROWS) if process_count is None
                       else process_count)
        if batch_size % self.pcount:
            raise ValueError(f"global batch {batch_size} not divisible by {self.pcount} ranks")
        self.batch_size = batch_size
        self.local_batch = batch_size // self.pcount
        self.seed = seed
        self.share = (
            sharding.microbatch_rows(batch_size, microbatches, self.pidx, self.pcount)
            if microbatches > 1 and self.pcount > 1 else None
        )

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        epoch = 0
        while True:
            order = np.random.default_rng((self.seed, epoch)).permutation(self.n)
            # Every rank's shard the same length, so the ranks cross epoch
            # boundaries at the same step.
            order = order[: self.n - (self.n % self.pcount)]
            blocks = [order[q :: self.pcount] for q in range(self.pcount)]
            lb = self.local_batch
            for s in range(len(blocks[self.pidx]) // lb):
                if self.share is None:
                    idx = blocks[self.pidx][s * lb : (s + 1) * lb]
                else:  # the global batch (every rank's rows), then our share
                    idx = np.concatenate([b[s * lb : (s + 1) * lb] for b in blocks])[self.share]
                yield {k: v[idx] for k, v in self.fields.items()}
            epoch += 1


def rank_batches(make, microbatches: int = 1, rank: int | None = None,
                 size: int | None = None) -> Iterator[dict[str, np.ndarray]]:
    """This rank's batches: ``make(rank)``, the stream of local batches a
    rank of the data axis reads; under ``microbatches`` > 1 on several
    ranks, this rank's share of each microbatch of the global batch (every
    rank's ``make(q)`` laid out rank 0's first), which each rank assembles
    from the deterministic streams alone.  ``rank`` of ``size`` row shards
    (default: the calling thread's, data x expert: ``sharding.ROWS``)."""
    size = collectives.axis_size(sharding.ROWS) if size is None else size
    rank = collectives.axis_index(sharding.ROWS) if rank is None else rank
    if microbatches <= 1 or size == 1:
        yield from make(rank)
        return
    for step in zip(*(make(q) for q in range(size))):
        glob = {k: np.concatenate([b[k] for b in step]) for k in step[0]}
        rows = sharding.microbatch_rows(len(glob[next(iter(glob))]), microbatches, rank, size)
        yield {k: v[rows] for k, v in glob.items()}


def seq_columns(it: Iterable[dict[str, np.ndarray]], index: int,
                count: int) -> Iterator[dict[str, np.ndarray]]:
    """Each [B, T] batch of ``it`` cut to seq rank ``index`` of ``count``'s
    columns (``sharding.seq_block``); ``it`` as it is for one seq rank."""
    for batch in it:
        yield batch if count == 1 else {
            k: sharding.seq_block(v, index, count) for k, v in batch.items()}


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
