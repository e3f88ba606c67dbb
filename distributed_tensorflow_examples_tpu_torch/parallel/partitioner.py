"""Variable partitioners: the port of
``distributed_tensorflow_examples_tpu/parallel/partitioner.py``.

The reference splits its word2vec table over parameter servers with
``tf.fixed_size_partitioner``; the JAX package turns that intent into a
``PartitionSpec`` over the ``model`` mesh axis, and so does the port, with
its own spec value (:class:`PartitionSpec`, since the port imports no
jax).  A spec is a tuple with one entry per dimension: a mesh axis name,
a tuple of names, or ``None`` (that dimension replicated); missing
trailing entries are ``None``.
"""

from __future__ import annotations


class PartitionSpec(tuple):
    """``P("model", None)``: a tuple of per-dimension mesh axes, equal as a
    tuple to the JAX ``PartitionSpec`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


P = PartitionSpec


def fixed_size_partitioner(axis_name: str = "model", dim: int = 0) -> PartitionSpec:
    """Shard dimension ``dim`` over mesh axis ``axis_name`` (the shard
    count is the axis's size, not a flag)."""
    return P(*([None] * dim + [axis_name]))


def min_max_variable_partitioner(min_slice_bytes: int = 256 << 10, axis_name: str = "model"):
    """``decide(shape, dtype_bytes=4, axis_size=1) -> PartitionSpec``: the
    leading dim over ``axis_name`` when each shard would still hold at
    least ``min_slice_bytes``, else replicated (a tiny bias would only add
    collective latency)."""

    def decide(shape, dtype_bytes: int = 4, axis_size: int = 1) -> PartitionSpec:
        if not shape:
            return P()
        nbytes = dtype_bytes
        for s in shape:
            nbytes *= s
        if nbytes // max(1, axis_size) < min_slice_bytes:
            return P()
        return P(axis_name)

    return decide
