"""Collectives over the mesh's ``data`` axis: the port of the part of
``distributed_tensorflow_examples_tpu/parallel/collectives.py`` that
data parallelism uses.

In the JAX package GSPMD emits the all-reduces of a sharded step; here
they are explicit.  The ``data`` axis is a data group: the process group
(``parallel/dist.py``) unless the calling thread installed another with
:func:`use_group`.  ``build_mesh`` attaches the group to the mesh, and
``build_train_step`` installs its mesh's group (``None``: one rank) for
the whole step, so the step, SyncBN, plain BN and the LSTM's dropout
rows all read the same one.  :func:`axis_size` and :func:`axis_index` are
the group's size and this rank, :func:`psum` sums a tensor over the ranks
with autograd (its backward sums the cotangent likewise, as JAX's
``psum`` transposes), and :func:`all_reduce_sum_` sums in place without
autograd (gradients, SyncBN's partial sums).  Without a group every one
of them is the identity on one rank.  :class:`ThreadRanks` runs simulated
ranks as threads of one process (the twin of the JAX package's
``local_mesh_for_testing``).
``TRAFFIC`` counts the calls, bytes and host seconds of each tag (the
seconds a call holds the host: the whole exchange on gloo, the enqueue
on nccl).  ``ring_permute`` and
``shard_map`` wait for the model-parallel slice (A8).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
import torch.distributed as tdist

#: Calls, bytes and host seconds of the in-place all-reduces, by tag:
#: ``TRAFFIC["<tag>_calls"]``, ``["<tag>_bytes"]``, ``["<tag>_seconds"]``.
TRAFFIC: collections.Counter = collections.Counter()


class ProcessGroup:
    """Every rank of the ``torch.distributed`` world."""

    @property
    def size(self) -> int:
        return tdist.get_world_size()

    @property
    def rank(self) -> int:
        return tdist.get_rank()

    def all_reduce_sum_(self, t: torch.Tensor) -> None:
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM)

    def all_gather_object(self, obj) -> list:
        out = [None] * self.size
        tdist.all_gather_object(out, obj)
        return out


_PROCESS_GROUP = ProcessGroup()
_local = threading.local()
_UNSET = object()  # no group installed on this thread


def group():
    """The calling thread's data group: one installed by :func:`use_group`
    (``None``: one rank), else the process group when one is up, else
    None."""
    installed = getattr(_local, "group", _UNSET)
    if installed is not _UNSET:
        return installed
    if tdist.is_available() and tdist.is_initialized():
        return _PROCESS_GROUP
    return None


@contextlib.contextmanager
def use_group(g):
    """Run the block with ``g`` (``size``, ``rank``, ``all_reduce_sum_``,
    ``all_gather_object``; ``None`` for one rank) as this thread's data
    group."""
    old = getattr(_local, "group", _UNSET)
    _local.group = g
    try:
        yield g
    finally:
        _local.group = old


def _check_axis(axis_name: str) -> None:
    if axis_name != "data":
        raise NotImplementedError(
            f"collectives over mesh axis {axis_name!r} wait for the port's "
            "model-parallel slice (A8); the port has the 'data' axis"
        )


def axis_size(axis_name: str = "data") -> int:
    """Ranks along the axis (1 without a group)."""
    _check_axis(axis_name)
    g = group()
    return g.size if g is not None else 1


def axis_index(axis_name: str = "data") -> int:
    """This rank's position along the axis (0 without a group)."""
    _check_axis(axis_name)
    g = group()
    return g.rank if g is not None else 0


def all_reduce_sum_(t: torch.Tensor, *, tag: str = "other") -> torch.Tensor:
    """Sum ``t`` over the ranks, in place, outside autograd; returns ``t``."""
    g = group()
    if g is not None:
        t0 = time.perf_counter()
        g.all_reduce_sum_(t)
        TRAFFIC[f"{tag}_seconds"] += time.perf_counter() - t0
        TRAFFIC[f"{tag}_calls"] += 1
        TRAFFIC[f"{tag}_bytes"] += t.numel() * t.element_size()
    return t


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, tag):
        ctx.g, ctx.tag = g, tag
        y = x.detach().clone()
        with use_group(g):
            return all_reduce_sum_(y, tag=tag)

    @staticmethod
    def backward(ctx, gy):
        gx = gy.detach().clone()
        with use_group(ctx.g):
            return all_reduce_sum_(gx, tag=ctx.tag), None, None


def psum(t: torch.Tensor, axis_name: str = "data", *, tag: str = "other") -> torch.Tensor:
    """``t`` summed over the axis, differentiable: the gradient of the
    sum is the sum of the ranks' cotangents (the transpose of JAX's
    ``psum``).  The identity without a group."""
    _check_axis(axis_name)
    g = group()
    if g is None:
        return t
    return _PSum.apply(t, g, tag)


def pmean(t: torch.Tensor, axis_name: str = "data", *, tag: str = "other") -> torch.Tensor:
    """``t`` averaged over the axis (differentiable)."""
    return psum(t, axis_name, tag=tag) / axis_size(axis_name)


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` on one rank)."""
    g = group()
    return g.all_gather_object(obj) if g is not None else [obj]


class ThreadRanks:
    """``n`` simulated ranks as threads of this process: :meth:`run`
    calls ``fn(rank)`` in each under a data group whose all-reduce sums
    the ranks' tensors in rank order (every rank gets the same bits)."""

    def __init__(self, n: int, *, timeout: float = 60.0):
        self.size = n
        self._barrier = threading.Barrier(n, timeout=timeout)
        self._slots: list = [None] * n

    def _exchange(self, rank: int, value) -> list:
        self._slots[rank] = value
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()  # nobody overwrites a slot before all have read
        return out

    def run(self, fn) -> list:
        """``[fn(0), ..., fn(n - 1)]``, each on its own thread; re-raises
        the first rank's exception."""
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(rank):
            try:
                with use_group(_ThreadRank(self, rank)):
                    results[rank] = fn(rank)
            except BaseException as e:  # handed to the caller below
                errors[rank] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,)) for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for e in errors:
            if e is not None and not isinstance(e, threading.BrokenBarrierError):
                raise e
        for e in errors:
            if e is not None:
                raise e
        return results


class _ThreadRank:
    def __init__(self, ranks: ThreadRanks, rank: int):
        self.ranks, self.rank, self.size = ranks, rank, ranks.size

    def all_reduce_sum_(self, t: torch.Tensor) -> None:
        parts = self.ranks._exchange(self.rank, t.detach().clone())
        total = parts[0].clone()
        for part in parts[1:]:
            total += part
        t.copy_(total)

    def all_gather_object(self, obj) -> list:
        return self.ranks._exchange(self.rank, obj)
