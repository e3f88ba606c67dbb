"""``--data_dir`` resolution for the image CLIs: the in-memory branch of
``distributed_tensorflow_examples_tpu/data/streams.py``.

The JAX package picks, in order: a ``dsvc://host:port`` data service,
``shard-*.dtxr`` chunks through its native loader, ``shard-*.npz`` chunks
through its streaming pipeline, else an in-RAM dataset from ``fallback()``
(a real file or synthetic).  The port has the last branch; the other three
wait for its data-plane item (A10) and raise here, so a run never trains
on the fallback when the directory holds a stream.
"""

from __future__ import annotations

import dataclasses
import glob
import logging
import os
from typing import Callable, Iterator

import numpy as np

from . import datasets
from .pipeline import InMemoryPipeline

log = logging.getLogger("dtx.data")

#: Shard files the JAX package streams (native loader, then npz/pickle chunks).
_STREAM_PATTERNS = ("shard-*.dtxr", "shard-*.npz", "shard-*.npy", "shard-*.pkl", "shard-*.pickle")


@dataclasses.dataclass(frozen=True)
class ImageSource:
    kind: str  # "memory" (the only kind the port has so far)
    ds: datasets.ArrayDataset


def _streamed(data_dir: str) -> list[str]:
    return sorted(
        f for pattern in _STREAM_PATTERNS for f in glob.glob(os.path.join(data_dir, pattern))
    )


def resolve_image_source(
    data_dir: str | None, *, fallback: Callable[[], datasets.ArrayDataset],
    name: str = "dataset",
) -> ImageSource:
    """The in-memory source from ``fallback()``; a data service or shard
    files under ``data_dir`` raise (A10)."""
    if data_dir and data_dir.startswith("dsvc://"):
        raise NotImplementedError(
            f"--data_dir={data_dir}: the remote data service waits for the port's "
            "data-plane item (A10)"
        )
    shards = _streamed(data_dir) if data_dir else []
    if shards:
        raise NotImplementedError(
            f"--data_dir={data_dir} holds {len(shards)} shard file(s) (e.g. "
            f"{os.path.basename(shards[0])}): streamed shards wait for the port's "
            "data-plane item (A10)"
        )
    ds = fallback()
    log.info("%s source: %s", name, ds.source)
    return ImageSource("memory", ds)


def train_iter(
    src: ImageSource, *, batch_size: int, seed: int, worker: int | None = None,
    n_workers: int = 1, microbatches: int = 1, mesh=None,
) -> Iterator[dict[str, np.ndarray]]:
    """Training batches of ``batch_size`` from an in-memory source, in the
    JAX pipeline's order for ``seed``: the rows of ``mesh``'s data index
    (default: the calling thread's data axis), under ``microbatches`` > 1
    on several ranks this rank's share of each microbatch
    (``InMemoryPipeline``).  With ``worker=w`` (one of ``n_workers``
    PS-emulation workers) the stream is worker w's own: the whole training
    split at seed ``seed + w``, as the JAX memory branch gives it."""
    if worker is not None:
        if not 0 <= worker < n_workers:
            raise ValueError(f"worker {worker} is not one of {n_workers} workers")
        return iter(InMemoryPipeline(src.ds.train, batch_size=batch_size, seed=seed + worker,
                                     process_index=0, process_count=1))
    index, count = (None, None) if mesh is None else (mesh.data_index, mesh.shape["data"])
    return iter(InMemoryPipeline(src.ds.train, batch_size=batch_size, seed=seed,
                                 process_index=index, process_count=count,
                                 microbatches=microbatches))
