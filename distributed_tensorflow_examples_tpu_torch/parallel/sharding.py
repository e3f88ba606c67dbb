"""Batch sharding over the ``data`` axis: the port of
``distributed_tensorflow_examples_tpu/parallel/sharding.py::batch_sharding``.

JAX lays a global batch out with its leading dim split over ``data``:
rank r holds rows ``[r * B/N, (r + 1) * B/N)``.  The port's ranks hold
those rows as local tensors, so the global batch is rank 0's rows, then
rank 1's, and so on.  :func:`rank_rows` is the slice of a rank's rows;
:func:`local_rows` takes them from a global tensor (a random draw shaped
by the global batch, an evaluation batch); :func:`global_batch` is the
global row count of a local batch; :func:`stream_block` is a rank's
block of a token stream (the LM CLIs' host shard).  The rule table of
parameter shardings waits for the model-parallel slice (A8).
"""

from __future__ import annotations

from . import collectives


def rank_rows(n_global: int, rank: int | None = None, size: int | None = None) -> slice:
    """The rows of ``rank`` (default: this one) in a global batch of
    ``n_global`` rows over ``size`` ranks (default: the data axis)."""
    size = collectives.axis_size() if size is None else size
    rank = collectives.axis_index() if rank is None else rank
    if n_global % size:
        raise ValueError(f"global batch {n_global} not divisible by {size} ranks")
    n = n_global // size
    return slice(rank * n, (rank + 1) * n)


def local_rows(x):
    """This rank's rows of a global tensor or array (leading dim)."""
    return x[rank_rows(x.shape[0])]


def global_batch(n_local: int) -> int:
    """The global row count of a batch with ``n_local`` rows on each rank."""
    return n_local * collectives.axis_size()


def stream_block(ids, batch_size: int):
    """(this rank's contiguous block of a token stream, its local rows of
    a global ``batch_size``): the JAX LM CLIs' per-host shard, each rank
    a disjoint block of the stream and of the batch rows."""
    n = collectives.axis_size()
    if batch_size % n:
        raise ValueError(f"--batch_size={batch_size} not divisible by {n} ranks")
    block = len(ids) // n
    r = collectives.axis_index()
    return ids[r * block : (r + 1) * block], batch_size // n
