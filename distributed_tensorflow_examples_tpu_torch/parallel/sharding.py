"""Sharding rules and batch sharding: the port of
``distributed_tensorflow_examples_tpu/parallel/sharding.py``.

The rule table.  A table is ordered ``(path regex, PartitionSpec)`` pairs
(``parallel/partitioner.py``'s spec value); the first rule whose regex
``re.search``-es a leaf's path (``"emb/table"``) gives its spec, no match
means replicated, and :func:`_clamp_spec` drops a sharding the axis does
not divide (that dim stays replicated), as the JAX functions do.
:func:`sharding_tree` is the tree of per-leaf specs and
:func:`shard_pytree` this rank's block of each global numpy leaf: where
JAX lays a leaf out over the mesh, a port rank holds its block as a
local tensor.  :func:`block` and :func:`sharded_dim` serve the
checkpoint's gathers and restores.

Batch rows: JAX lays a global batch out with its leading dim split over
``("slice", "data", "expert")`` (``ROWS``; the slice axis is 1 outside
a ghost-batch BN mesh and the expert axis outside a mixture-of-experts
mesh), slice major: row shard r holds rows
``[r * B/N, (r + 1) * B/N)``.  The port's ranks hold
those rows as local tensors, so the global batch is rank 0's rows, then
rank 1's, and so on.  :func:`rank_rows` is the slice of a rank's rows;
:func:`local_rows` takes them from a global tensor (a random draw shaped
by the global batch, an evaluation batch); :func:`global_batch` is the
global row count of a local batch; :func:`stream_block` is a rank's
block of a token stream (the LM CLIs' host shard);
:func:`microbatch_rows` is a rank's share of each microbatch of a global
batch under gradient accumulation.  Every one of them reads the row
shards: the ranks of one row shard (the ``pipe``, ``seq`` and ``model`` ranks
of one slice, data and expert index) hold the same rows.  A ``seq`` axis then splits the
sequence: :func:`seq_block` is a rank's columns ``[s T/S, (s + 1) T/S)``
of a [B, T] batch field (JAX's ``batch_spec``, ``P("data", "seq")``).
"""

from __future__ import annotations

import re
from typing import Any, Callable, Sequence

import numpy as np

from . import collectives
from .partitioner import PartitionSpec

P = PartitionSpec
#: Ordered (path regex, PartitionSpec) pairs; first match wins.
ShardingRules = Sequence[tuple[str, PartitionSpec]]

REPLICATED = P()
#: The axes the batch's rows split over, slice major (JAX's
#: ``batch_sharding`` over ``("slice", "data")`` and ``Config.data_axes`` of
#: a mixture-of-experts model; each axis is 1 where it is not used).
ROWS = ("slice", "data", "expert")


def path_of(key_path) -> str:
    """A tree key path (dict keys, sequence indices) as ``"a/b/0"``."""
    return "/".join(str(k) for k in key_path)


def match_rule(path: str, rules: ShardingRules) -> PartitionSpec | None:
    """The first matching rule's spec, or None when no rule matches."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return None


def spec_for_path(path: str, rules: ShardingRules) -> PartitionSpec:
    spec = match_rule(path, rules)
    return REPLICATED if spec is None else P(*spec)


def _axis_sizes(mesh) -> dict:
    """A ``Mesh``'s axis sizes (or a dict of them); an absent axis is 1."""
    return dict(getattr(mesh, "shape", mesh))


def _clamp_spec(spec, ndim: int, shape, mesh) -> PartitionSpec:
    """Drop entries beyond ``ndim``, and shardings whose axes' product
    does not divide the dimension (that dim stays replicated)."""
    sizes = _axis_sizes(mesh)
    out: list[Any] = []
    for dim, entry in enumerate(list(spec)[:ndim]):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for a in axes:
            size *= sizes.get(a, 1)
        out.append(entry if shape[dim] % size == 0 else None)
    return P(*out)


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, (*path, k)) for k, v in tree.items()}
    return fn(path, tree)


def sharding_tree(tree, mesh, rules: ShardingRules, *,
                  default_spec_fn: Callable | None = None):
    """The tree of each leaf's clamped spec.  ``default_spec_fn(path,
    leaf)`` decides the leaves no rule matches (default replicated)."""

    def one(key_path, leaf):
        path = path_of(key_path)
        spec = match_rule(path, rules)
        if spec is None:
            spec = default_spec_fn(path, leaf) if default_spec_fn else REPLICATED
        shape = tuple(getattr(leaf, "shape", ()))
        return _clamp_spec(spec, len(shape), shape, mesh)

    return _tree_map_with_path(one, tree)


def _axis_block(entry, mesh) -> tuple[int, int]:
    """(this rank's block index, block count) along a spec entry."""
    axes = entry if isinstance(entry, tuple) else (entry,)
    index, count = 0, 1
    for a in axes:
        n = _axis_sizes(mesh).get(a, 1)
        index, count = index * n + mesh.index(a), count * n
    return index, count


def block(x, spec, mesh):
    """This rank's block of the global array or tensor ``x`` under
    ``spec`` (``x`` itself when the spec is replicated)."""
    index = []
    for dim, entry in enumerate(spec):
        if entry is None:
            index.append(slice(None))
            continue
        i, n = _axis_block(entry, mesh)
        size = x.shape[dim] // n
        index.append(slice(i * size, (i + 1) * size))
    return x[tuple(index)] if index else x


def sharded_dim(spec, axis: str) -> int | None:
    """The dimension ``spec`` shards over ``axis`` alone, or None."""
    for dim, entry in enumerate(spec):
        if entry == axis:
            return dim
    return None


def shard_pytree(tree, mesh, rules: ShardingRules = ()):
    """This rank's block of every global leaf of ``tree`` under the rule
    table (the port of JAX's ``device_put`` onto the rule shardings)."""
    specs = sharding_tree(tree, mesh, rules)
    return _tree_map_with_path(
        lambda path, leaf: block(leaf, _get(specs, path), mesh), tree)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def rank_rows(n_global: int, rank: int | None = None, size: int | None = None) -> slice:
    """The rows of ``rank`` (default: this one) in a global batch of
    ``n_global`` rows over ``size`` ranks (default: the row shards,
    ``ROWS``)."""
    size = collectives.axis_size(ROWS) if size is None else size
    rank = collectives.axis_index(ROWS) if rank is None else rank
    if n_global % size:
        raise ValueError(f"global batch {n_global} not divisible by {size} ranks")
    n = n_global // size
    return slice(rank * n, (rank + 1) * n)


def local_rows(x):
    """This rank's rows of a global tensor or array (leading dim)."""
    return x[rank_rows(x.shape[0])]


def global_batch(n_local: int) -> int:
    """The global row count of a batch with ``n_local`` rows on each rank."""
    return n_local * collectives.axis_size(ROWS)


def stream_block(ids, batch_size: int, rank: int | None = None, size: int | None = None):
    """(the contiguous block of a token stream of ``rank``, default this
    one, its local rows of a global ``batch_size``) over ``size`` ranks
    (default: the row shards, ``ROWS``): the JAX LM CLIs' per-host shard,
    each rank a disjoint block of the stream and of the batch rows."""
    n = collectives.axis_size(ROWS) if size is None else size
    if batch_size % n:
        raise ValueError(f"--batch_size={batch_size} not divisible by {n} ranks")
    block = len(ids) // n
    r = collectives.axis_index(ROWS) if rank is None else rank
    return ids[r * block : (r + 1) * block], batch_size // n


def microbatch_rows(n_global: int, microbatches: int, rank: int, size: int) -> np.ndarray:
    """Row indices, into a global batch of ``n_global`` rows laid out rank
    0's rows first, of ``rank``'s share of each of the ``microbatches``
    microbatches the JAX step cuts it into (its ``_split``: microbatch i is
    global rows ``[i n/k, (i+1) n/k)``): rows ``[r n/(kN), (r+1) n/(kN))``
    of each, microbatch 0's first.  A local batch in this order splits
    (``chunk(k)``) into the rank's rows of each microbatch, so a
    microbatch's BatchNorm statistics sum over the ranks and a draw shaped
    by the global microbatch (:func:`local_rows`) gives each rank its
    rows."""
    if n_global % (microbatches * size):
        raise ValueError(
            f"global batch {n_global} not divisible by {microbatches} microbatches "
            f"x {size} ranks")
    return np.arange(n_global).reshape(microbatches, size, -1)[:, rank].reshape(-1)


def seq_block(x, index: int, count: int):
    """The columns ``[index T/count, (index + 1) T/count)`` of the [B, T, ...]
    ``x``: a rank's slice of the sequence over ``count`` seq ranks."""
    t = x.shape[1]
    if t % count:
        raise ValueError(f"sequence length {t} not divisible by seq={count}")
    n = t // count
    return x[:, index * n : (index + 1) * n]
