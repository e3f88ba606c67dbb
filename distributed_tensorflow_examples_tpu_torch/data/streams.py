"""``--data_dir`` resolution for the image CLIs (W2 cifar10, W3 resnet50):
the port of ``distributed_tensorflow_examples_tpu/data/streams.py``.

One place implements the source selection every image example needs
(SURVEY.md T7), so the CLIs cannot drift:

- ``dsvc://host:port`` -> REMOTE disaggregated data service
                       (``data/data_service.py``): ready batches streamed
                       from dedicated input workers over the PS wire,
- ``shard-*.dtxr``  -> NATIVE C++ loader (``native/dataloader.cc``),
- ``shard-*.npz``   -> Python streaming pipeline (``filestream``),
- anything else     -> in-RAM dataset from ``fallback()`` (real file or
                       synthetic).

Nothing falls back quietly: a ``.dtxr`` directory whose native library
does not build raises, and an unreachable ``dsvc://`` service raises once
the client's reconnect deadline passes.  The LAST shard is held out as the
eval split (one chunk in RAM) so test accuracy measures the streamed
distribution; a single-shard directory reuses it for eval with an explicit
memorization warning.

Ranks of the row shards (data x expert).  The in-memory branch gives each rank its rows of
the JAX one-process global batch (``InMemoryPipeline``).  A streamed source
gives rank ``r`` of ``N`` the JAX package's own per-worker split instead,
``train_iter(worker=r, n_workers=N)`` at the local batch ``batch_size / N``
(native: shards ``r::N`` at seed ``seed + r``; npz stream: row stride
``process_index=r``; dsvc: ``worker_id=r``): a shared native stream's order
is not the same on two ranks, so "each rank keeps its rows of one stream"
would drop or repeat rows.  Under ``--grad_accum`` > 1 that local batch
splits locally.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Iterator

import numpy as np

from ..parallel import collectives
from ..parallel.sharding import ROWS
from . import datasets, filestream, native_loader
from .pipeline import InMemoryPipeline

log = logging.getLogger("dtx.data")


@dataclasses.dataclass(frozen=True)
class ImageSource:
    kind: str  # "dsvc" | "native" | "stream" | "memory"
    ds: datasets.ArrayDataset  # .test always populated; .train only for memory
    train_shards: list[str] = dataclasses.field(default_factory=list)
    remote_spec: str = ""  # "dsvc://host:port" for kind == "dsvc"


def resolve_image_source(
    data_dir: str | None,
    *,
    fallback: Callable[[], datasets.ArrayDataset],
    seed: int = 0,
    num_classes: int = 0,
    name: str = "dataset",
    tenant: str = "default",
) -> ImageSource:
    """The source ``data_dir`` names, in the JAX package's order (module
    docstring); the eval split of a streamed source is its held-out
    shard, decoded with ``image_decode_fn(seed=seed)``."""
    if data_dir and data_dir.startswith("dsvc://"):
        from . import data_service

        # The server owns shards, decode and split assignment; the eval
        # chunk is its held-out shard, served raw and decoded here like the
        # on-disk branches.  worker_id=-1: a metadata-only probe never
        # counts as a training worker in the dispatcher's liveness tables.
        probe = data_service.RemoteDatasetSource(data_dir, worker_id=-1, tenant=tenant)
        try:
            raw_eval = probe.eval_chunk()
            if raw_eval is None:
                raise ValueError(f"data service {data_dir} serves no eval chunk")
            n_splits = probe.num_splits
        finally:
            probe.close()
        test = filestream.image_decode_fn(seed=seed)(raw_eval)
        log.info("%s source: %s (%d remote splits)", name, data_dir, n_splits)
        return ImageSource("dsvc", datasets.ArrayDataset({}, test, data_dir, num_classes),
                           [], remote_spec=data_dir)
    raw = native_loader.list_raw_shards(data_dir) if data_dir else []
    if raw:
        test = filestream.image_decode_fn(seed=seed)(native_loader.read_raw_shard(raw[-1]))
        train, held = _holdout(raw)
        log.info("%s source: native:%s (%d train shards, C++ loader, %s)",
                 name, data_dir, len(train), held)
        return ImageSource(
            "native", datasets.ArrayDataset({}, test, f"native:{data_dir}", num_classes), train)
    npz = filestream.list_shards(data_dir) if data_dir else []
    if npz:
        test = filestream.image_decode_fn(seed=seed)(filestream.load_chunk(npz[-1]))
        train, held = _holdout(npz)
        log.info("%s source: stream:%s (%d train shards, %s)", name, data_dir, len(train), held)
        return ImageSource(
            "stream", datasets.ArrayDataset({}, test, f"stream:{data_dir}", num_classes), train)
    ds = fallback()
    log.info("%s source: %s", name, ds.source)
    return ImageSource("memory", ds)


def _holdout(shards: list[str]) -> tuple[list[str], str]:
    if len(shards) > 1:
        return shards[:-1], "1 held-out eval shard"
    return shards, "eval REUSES the single train shard (memorization!)"


def train_iter(
    src: ImageSource, *, batch_size: int, seed: int, augment: bool = True,
    worker: int | None = None, n_workers: int = 1, tenant: str = "default",
    microbatches: int = 1, mesh=None,
) -> Iterator[dict[str, np.ndarray]]:
    """Training batches of ``batch_size`` from the resolved source.

    ``worker``/``n_workers``: the PS-emulation per-worker split, as in JAX:
    worker w streams a disjoint shard subset (native) / row stride (stream)
    / its own claims (dsvc) / its own sample stream (memory), each with a
    worker-distinct seed.  Without ``worker``, ``batch_size`` is the global
    batch of the row shards (slice x data x expert; ``mesh``'s, default the calling
    thread's): an in-memory source yields this rank's rows of the JAX
    pipeline's batch
    (under ``microbatches`` > 1 on several ranks, its share of each
    microbatch); a streamed source yields rank r of N the split of worker
    r of N at ``batch_size / N`` rows (module docstring)."""
    if worker is None:
        if mesh is None:
            index, count = collectives.axis_index(ROWS), collectives.axis_size(ROWS)
        else:  # the row shards, slice major, then data, then expert
            index, count = 0, 1
            for a in ROWS:
                n = mesh.shape.get(a, 1)
                i = mesh.data_index if a == "data" else (mesh.index(a) if n > 1 else 0)
                index, count = index * n + i, count * n
        if src.kind == "memory":
            return iter(InMemoryPipeline(src.ds.train, batch_size=batch_size, seed=seed,
                                         process_index=index, process_count=count,
                                         microbatches=microbatches))
        if batch_size % count:
            raise ValueError(f"global batch {batch_size} not divisible by {count} ranks")
        return _worker_iter(src, batch_size=batch_size // count, seed=seed, augment=augment,
                            w=index, n_workers=count, tenant=tenant)
    if not 0 <= worker < n_workers:
        raise ValueError(f"worker {worker} is not one of {n_workers} workers")
    if src.kind == "memory":
        return iter(InMemoryPipeline(src.ds.train, batch_size=batch_size, seed=seed + worker,
                                     process_index=0, process_count=1))
    return _worker_iter(src, batch_size=batch_size, seed=seed, augment=augment, w=worker,
                        n_workers=n_workers, tenant=tenant)


def _worker_iter(src: ImageSource, *, batch_size: int, seed: int, augment: bool, w: int,
                 n_workers: int, tenant: str) -> Iterator[dict[str, np.ndarray]]:
    """Worker ``w`` of ``n_workers``'s batches from a streamed source, the
    JAX ``train_iter``'s three streamed branches."""
    if src.kind == "dsvc":
        from . import data_service

        # Batches arrive READY (decoded/augmented on the data server);
        # double-buffered prefetch hides the wire under local compute.  The
        # SERVER's pipeline settings win over this call's arguments, and
        # every mismatch warns.  The claim stream runs under the caller's
        # tenant: split assignment, epoch position and liveness all live in
        # this tenant's dispatcher job on the shared server.
        remote = data_service.RemoteDatasetSource(src.remote_spec, worker_id=w, tenant=tenant)
        info = remote.server_info
        server_bs = int(info.get("batch_size", batch_size))
        if server_bs != batch_size:
            log.warning("data service serves batch_size=%d (requested %d): the server's "
                        "setting wins — relaunch it to change", server_bs, batch_size)
        if "seed" in info and int(info["seed"]) != seed:
            log.warning("data service pipeline runs seed=%s (requested %d): batches are NOT "
                        "reproducible under the requested seed — relaunch the data service "
                        "to change", info["seed"], seed)
        if "augment" in info and bool(info["augment"]) != augment:
            log.warning("data service pipeline runs augment=%s (requested %s): the server's "
                        "decode_fn wins", info["augment"], augment)

        def stream():
            try:
                yield from remote.batches(repeat=True)
            finally:
                remote.close()

        return stream()
    decode = filestream.image_decode_fn(augment=augment, seed=seed)
    if src.kind == "native":
        shards = src.train_shards[w::n_workers]
        if not shards:
            # Disjointness is the contract (the npz path row-strides, so any
            # n_workers works there); re-streaming ALL shards would
            # duplicate data across workers.
            raise ValueError(
                f"native loader: {len(src.train_shards)} train shard(s) cannot give "
                f"{n_workers} workers disjoint streams — write more shards "
                "(shard_records smaller) or fewer workers")
        return (decode(b) for b in native_loader.NativeFileStream(
            shards, batch_size=batch_size, seed=seed + w, repeat=True))
    if src.kind == "stream":
        return iter(filestream.FileStreamPipeline(
            src.train_shards, batch_size=batch_size * n_workers, decode_fn=decode, seed=seed,
            process_index=w, process_count=n_workers))
    raise ValueError(f"unknown image source kind {src.kind!r}")
