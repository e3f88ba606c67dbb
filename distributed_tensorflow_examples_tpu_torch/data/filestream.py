"""File-backed out-of-core streaming input: the port of
``distributed_tensorflow_examples_tpu/data/filestream.py`` (SURVEY.md
section 2c T7), numpy throughout, batch for batch the JAX module's.

``tf.data``'s real job in the reference stack is streaming datasets that do
not fit in host RAM: interleaved shard-file reads, parallel decode/augment,
and prefetch ahead of the accelerator.  ``InMemoryPipeline`` covers the
reference workloads whose datasets fit in RAM; this module is the on-disk
path:

- **Shard files** — a directory of ``shard-NNNNN.npz`` chunk files (or
  pickle chunks), each holding a slice of every field
  (:func:`write_array_shards` writes them, byte for byte as the JAX
  writer).  Only ONE chunk (plus the decode/prefetch queues) is resident
  per host at any time, so dataset size is bounded by disk, not RAM.
- **Rank sharding** — each reader takes ``files[pidx::pcount]`` (the
  ``Dataset.shard`` analog at file granularity).  ``process_index`` and
  ``process_count`` default to the calling thread's ``data`` axis (the
  rank's data index and the data size, ``parallel.collectives``) where JAX
  takes ``jax.process_index()``/``jax.process_count()``; code outside a
  step (a prefetch thread sees no installed group) passes them.
- **Reader thread** — loads the next chunk while the current one is being
  batched (``num_parallel_reads`` role).
- **Decode pool** — a thread pool maps ``decode_fn`` over batches, keeping
  several in flight while preserving order (``map(...,
  num_parallel_calls)`` role).
- Downstream, ``pipeline.prefetch_to_device`` overlaps the host-to-device
  copy.

Shuffle follows the tf.data recipe for streamed data: shuffle the FILE
order per epoch and the rows WITHIN each chunk, both from deterministic
per-epoch numpy seeds every rank agrees on.  :func:`image_decode_fn`
seeds each batch's flips from numpy's generator too (never torch's), so
decode gives the same bits whichever thread runs it.
"""

from __future__ import annotations

import concurrent.futures
import glob as glob_lib
import os
import pickle
import queue
import threading
import time
from collections import deque
from typing import Callable, Iterator

import numpy as np

_SHARD_FMT = "shard-{:05d}.npz"


def write_array_shards(
    directory: str,
    arrays: dict[str, np.ndarray],
    *,
    rows_per_shard: int,
    compress: bool = False,
) -> list[str]:
    """Split field arrays into ``shard-NNNNN.npz`` chunk files under
    ``directory`` (the fixture writer / dataset converter)."""
    lengths = {k: len(v) for k, v in arrays.items()}
    if len(set(lengths.values())) != 1:
        raise ValueError(f"mismatched field lengths {lengths}")
    n = next(iter(lengths.values()))
    os.makedirs(directory, exist_ok=True)
    save = np.savez_compressed if compress else np.savez
    paths = []
    for i, start in enumerate(range(0, n, rows_per_shard)):
        path = os.path.join(directory, _SHARD_FMT.format(i))
        save(path, **{k: v[start : start + rows_per_shard] for k, v in arrays.items()})
        paths.append(path)
    return paths


def list_shards(directory: str, pattern: str = "shard-*") -> list[str]:
    """Sorted shard files under ``directory`` (npz or pickle chunks)."""
    files = sorted(glob_lib.glob(os.path.join(directory, pattern)))
    return [f for f in files if f.endswith((".npz", ".npy", ".pkl", ".pickle"))]


def load_chunk(path: str) -> dict[str, np.ndarray]:
    """Load one shard file fully into RAM (public: CLIs use it to hold out
    an eval shard)."""
    return _load_chunk(path)


def _load_chunk(path: str) -> dict[str, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path) as d:
            return {k: d[k] for k in d.files}
    if path.endswith((".pkl", ".pickle")):
        with open(path, "rb") as f:
            d = pickle.load(f)
        return {k: np.asarray(v) for k, v in d.items()}
    raise ValueError(f"unsupported shard format: {path}")


class FileStreamPipeline:
    """Out-of-core batch stream over shard files.

    Yields local (per-rank) ``{field: np.ndarray}`` batches forever (or one
    epoch when ``repeat=False``); feed through
    ``pipeline.prefetch_to_device`` for the device infeed.  ``batch_size``
    is GLOBAL (divided by the rank count, like ``InMemoryPipeline``).

    ``stats`` counters (read anytime): ``chunks_loaded``, ``batches``,
    ``consumer_waits`` — the number of times the consumer found no decoded
    batch ready (prefetch starvation; the no-starvation test asserts this
    stays at ~0 when decode keeps up), and ``read_wait_s`` — time the batcher
    spent blocked on disk reads.
    """

    def __init__(
        self,
        files: list[str] | str,
        *,
        batch_size: int,
        decode_fn: Callable[[dict[str, np.ndarray]], dict[str, np.ndarray]] | None = None,
        shuffle: bool = True,
        seed: int = 0,
        repeat: bool = True,
        drop_remainder: bool = True,
        num_decode_workers: int = 2,
        read_ahead: int = 2,
        process_index: int | None = None,
        process_count: int | None = None,
    ):
        self.files = list_shards(files) if isinstance(files, str) else list(files)
        if not self.files:
            raise ValueError(f"no shard files in {files!r}")
        from ..parallel import collectives  # torch: only a pipeline needs the rank

        self.pidx = collectives.axis_index() if process_index is None else process_index
        self.pcount = collectives.axis_size() if process_count is None else process_count
        if batch_size % self.pcount:
            raise ValueError(
                f"global batch {batch_size} not divisible by {self.pcount} hosts"
            )
        self.local_batch = batch_size // self.pcount
        self.decode_fn = decode_fn
        self.shuffle = shuffle
        self.seed = seed
        self.repeat = repeat
        self.drop_remainder = drop_remainder
        self.num_decode_workers = max(1, num_decode_workers)
        self.read_ahead = max(1, read_ahead)
        self.stats = {
            "chunks_loaded": 0,
            "batches": 0,
            "consumer_waits": 0,
            "read_wait_s": 0.0,
        }

    # -- epoch plumbing ------------------------------------------------------

    def _epoch_files(self, epoch: int) -> list[str]:
        """This host's file list for ``epoch`` (deterministic shuffle all
        hosts agree on, then stride-shard by host)."""
        order = np.arange(len(self.files))
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch)).permutation(order)
        elif len(order) % self.pcount:
            # Unshuffled + uneven file count: rotate per epoch so the
            # truncated tail file CYCLES instead of the same file being
            # dropped forever (silent permanent data loss otherwise).
            order = np.roll(order, -(epoch % len(order)))
        if len(self.files) >= self.pcount:
            order = order[: len(order) - (len(order) % self.pcount)]
            mine = order[self.pidx :: self.pcount]
        else:
            # Fewer files than hosts: every host reads all files and strides
            # ROWS instead (handled in _chunk_rows) — correct, just no IO win.
            mine = order
        return [self.files[i] for i in mine]

    def _chunk_rows(self, chunk: dict[str, np.ndarray], epoch: int, ci: int):
        n = len(next(iter(chunk.values())))
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng((self.seed, epoch, ci)).permutation(order)
        if len(self.files) < self.pcount:
            order = order[: n - (n % self.pcount)][self.pidx :: self.pcount]
        return {k: v[order] for k, v in chunk.items()}

    def _reader(self, epoch: int, out: queue.Queue, stop: threading.Event):
        """Loads this epoch's chunks into ``out`` ahead of the batcher.

        Every put polls ``stop`` so an abandoned consumer (break mid-epoch)
        can never leave this thread blocked on a full queue."""

        def _put(item) -> bool:
            while True:
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    if stop.is_set():
                        return False

        try:
            for ci, path in enumerate(self._epoch_files(epoch)):
                if stop.is_set():
                    return
                chunk = self._chunk_rows(_load_chunk(path), epoch, ci)
                self.stats["chunks_loaded"] += 1
                if not _put(chunk):
                    return
        except Exception as e:  # surfaced by the batcher
            _put(e)
        finally:
            _put(None)

    def _epoch_batches(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        """Undecoded local batches for one epoch; carries remainder rows
        across chunk boundaries so only the epoch tail is ever dropped."""
        q: queue.Queue = queue.Queue(maxsize=self.read_ahead)
        stop = threading.Event()
        t = threading.Thread(
            target=self._reader, args=(epoch, q, stop), daemon=True,
            name="filestream-reader",
        )
        t.start()
        carry: dict[str, np.ndarray] | None = None
        try:
            while True:
                t0 = time.perf_counter()
                chunk = q.get()
                self.stats["read_wait_s"] += time.perf_counter() - t0
                if chunk is None:
                    break
                if isinstance(chunk, Exception):
                    raise chunk
                if carry is not None:
                    chunk = {
                        k: np.concatenate([carry[k], v]) for k, v in chunk.items()
                    }
                n = len(next(iter(chunk.values())))
                b = self.local_batch
                for s in range(n // b):
                    yield {k: v[s * b : (s + 1) * b] for k, v in chunk.items()}
                rem = n % b
                carry = {k: v[n - rem :] for k, v in chunk.items()} if rem else None
            if carry is not None and not self.drop_remainder:
                yield carry
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    # -- public iterator -----------------------------------------------------

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=self.num_decode_workers, thread_name_prefix="filestream-decode"
        )
        decode = self.decode_fn or (lambda b: b)
        in_flight: deque = deque()
        depth = self.num_decode_workers + 2
        try:
            epoch = 0
            while True:
                for raw in self._epoch_batches(epoch):
                    in_flight.append(pool.submit(decode, raw))
                    if len(in_flight) >= depth:
                        fut = in_flight.popleft()
                        if not fut.done():
                            self.stats["consumer_waits"] += 1
                        self.stats["batches"] += 1
                        yield fut.result()
                epoch += 1
                if not self.repeat:
                    break
            while in_flight:
                fut = in_flight.popleft()
                if not fut.done():
                    self.stats["consumer_waits"] += 1
                self.stats["batches"] += 1
                yield fut.result()
        finally:
            for fut in in_flight:
                fut.cancel()
            pool.shutdown(wait=False, cancel_futures=True)


# ----------------------------------------------------------------------------
# Standard decoders (the `.map()` bodies of the reference's input fns)
# ----------------------------------------------------------------------------


def image_decode_fn(
    *,
    augment: bool = False,
    seed: int = 0,
    dtype=np.float32,
    scale: float = 1.0 / 255.0,
    mean: float = 0.5,
):
    """uint8 image chunks -> normalised float batches, with optional random
    horizontal-flip augmentation (the CIFAR/ImageNet train-time map).

    Decode runs on a thread pool, so each call derives its own Generator —
    numpy Generators are not thread-safe — seeded from (seed, batch content):
    deterministic for a given batch no matter which worker thread runs it or
    in what order."""
    import zlib

    def decode(batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        tag = zlib.adler32(batch["image"][:4].tobytes())
        rng = np.random.default_rng((seed, tag))
        out = dict(batch)
        img = batch["image"]
        if img.dtype == np.uint8:
            img = img.astype(dtype) * scale - mean
        else:
            img = img.astype(dtype)
        if augment:
            flip = rng.random(len(img)) < 0.5
            img[flip] = img[flip, :, ::-1]
        out["image"] = img
        if "label" in out:
            out["label"] = out["label"].astype(np.int32)
        return out

    return decode


# ----------------------------------------------------------------------------
# Streamed tokenised text (W4/W5 corpora too large for RAM)
# ----------------------------------------------------------------------------


def stream_token_ids(
    paths: list[str] | str,
    *,
    vocab: dict[str, int],
    chunk_words: int = 1 << 20,
) -> Iterator[np.ndarray]:
    """Tokenise text file(s) incrementally: yields int32 id chunks without
    ever holding the whole corpus (the TextLineDataset -> lookup-table map).
    Words absent from ``vocab`` map to id 0 (<unk>)."""
    if isinstance(paths, str):
        paths = [paths]
    buf: list[str] = []
    for path in paths:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            tail = ""
            while True:
                text = f.read(1 << 22)  # 4 MB of characters at a time
                if not text:
                    break
                text = tail + text
                # Keep a possibly-split trailing word for the next read.
                cut = len(text)
                while cut > 0 and not text[cut - 1].isspace():
                    cut -= 1
                tail = text[cut:]
                buf.extend(text[:cut].split())
                while len(buf) >= chunk_words:
                    yield np.asarray(
                        [vocab.get(w, 0) for w in buf[:chunk_words]], np.int32
                    )
                    del buf[:chunk_words]
            if tail:
                buf.append(tail)
    if buf:
        yield np.asarray([vocab.get(w, 0) for w in buf], np.int32)


def streamed_skipgram_batches(
    id_chunks,
    *,
    batch_size: int,
    window: int = 5,
    seed: int = 0,
) -> Iterator[dict[str, np.ndarray]]:
    """Skip-gram pair stream over token-id chunks (out-of-core analog of
    ``datasets.skipgram_batches``): samples pairs within each chunk, chaining
    chunks forever.

    Pass a CALLABLE returning a fresh chunk iterator (e.g. ``lambda:
    stream_token_ids(path, vocab=v)``) to stay out-of-core across epochs —
    the corpus is re-streamed per epoch with only one chunk resident.  A
    plain iterator is accepted but gets buffered in RAM for the repeat
    (fine for corpora that fit; defeats out-of-core otherwise).
    """
    rng = np.random.default_rng(seed)
    if callable(id_chunks):
        while True:  # re-stream the corpus each epoch: one chunk resident
            produced = False
            for chunk in id_chunks():
                produced = True
                yield from _skipgram_from(chunk, batch_size, window, rng)
            if not produced:
                raise ValueError(
                    "empty token stream — the factory must return a FRESH "
                    "iterator each call (a reused exhausted generator yields "
                    "nothing on re-iteration)"
                )
    else:
        chunks = []
        for chunk in id_chunks:
            chunks.append(chunk)
            yield from _skipgram_from(chunk, batch_size, window, rng)
        if not chunks:
            raise ValueError("empty token stream")
        while True:  # corpus exhausted: cycle the buffered chunks
            for chunk in chunks:
                yield from _skipgram_from(chunk, batch_size, window, rng)


def _skipgram_from(ids: np.ndarray, batch_size: int, window: int, rng):
    n = len(ids)
    if n < 2 * window + 1:
        return
    # One pass worth of pairs: ~1 batch per batch_size tokens keeps epoch
    # cost linear in corpus size.
    for _ in range(max(1, n // batch_size)):
        centers = rng.integers(window, n - window, size=batch_size)
        offsets = rng.integers(1, window + 1, size=batch_size)
        signs = rng.choice([-1, 1], size=batch_size)
        yield {
            "center": ids[centers].astype(np.int32),
            "context": ids[centers + offsets * signs].astype(np.int32),
        }
