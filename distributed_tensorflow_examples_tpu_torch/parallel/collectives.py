"""Collectives over the mesh's ``data`` and ``model`` axes: the port of
the part of ``distributed_tensorflow_examples_tpu/parallel/collectives.py``
that data parallelism and the vocab-parallel tables use.

In the JAX package GSPMD emits the all-reduces of a sharded step; here
they are explicit.  Each axis is a group of ranks.  The world's rank r
sits at ``data_index = r // M``, ``model_index = r % M`` (``model``
innermost, the JAX ``DEFAULT_AXES`` order): the ``data`` group is the
ranks of one model index, the ``model`` group the ranks of one data
index.  :func:`mesh_groups` makes them (``torch.distributed.new_group``,
called by every rank in one order; an axis that spans the world is the
world itself, and an axis of 1 has no group).  ``build_mesh`` attaches
them to the mesh.  Code reads an axis's group from the calling thread:
``build_train_step`` installs its mesh's groups for the whole step
(:func:`use_group`), so the step, SyncBN, plain BN, the LSTM's dropout
rows and the vocab-parallel layers all read the same ones, and code
outside a step (the input streams, the checkpoint, evaluation) runs
under ``Mesh.axes()``, which installs them likewise.  With none
installed the ``data`` axis is the world (the process group, or one
rank) and the ``model`` axis one rank.

:func:`axis_size` and :func:`axis_index` are an axis's size and this
rank's place on it; :func:`psum` sums a tensor over an axis with
autograd (its backward sums the cotangent likewise, as JAX's ``psum``
transposes); :func:`all_reduce_sum_` sums in place without autograd
(gradients, SyncBN's partial sums).  The two operators a vocab-parallel
layer needs, and GSPMD derives by itself: :func:`copy_to_model`, the
identity forward and a sum over ``model`` backward (an activation that
enters a row-sharded product), and :func:`reduce_from_model`, a sum over
``model`` forward and the identity backward (the partial results of the
row blocks).  ``psum`` is neither: the loss after a lookup is replicated
over ``model``, so its backward would scale the table gradient by M.
Without a group every one of them is the identity on one rank.
:class:`ThreadRanks` runs simulated ranks as threads of one process (the
twin of the JAX package's ``local_mesh_for_testing``); a 2-D mesh built
on them makes its groups from the same threads.  ``TRAFFIC`` counts the calls, bytes and host seconds of
each tag (the seconds a call holds the host: the whole exchange on gloo,
the enqueue on nccl); the model axis's sums count under ``model_fwd``
(forward) and ``model_bwd`` (backward).  ``ring_permute`` and
``shard_map`` wait for the sequence and pipeline axes (A8b).
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
    """The ranks of the ``torch.distributed`` world (``pg`` None) or of one
    of its subgroups."""

    def __init__(self, pg=None):
        self.pg = pg
        self._mesh_groups: dict = {}

    @property
    def size(self) -> int:
        return tdist.get_world_size(self.pg)

    @property
    def rank(self) -> int:
        return tdist.get_rank(self.pg)

    def all_reduce_sum_(self, t: torch.Tensor) -> None:
        tdist.all_reduce(t, op=tdist.ReduceOp.SUM, group=self.pg)

    def all_reduce_max_(self, t: torch.Tensor) -> None:
        tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=self.pg)

    def all_gather(self, t: torch.Tensor) -> list:
        out = [torch.empty_like(t) for _ in range(self.size)]
        tdist.all_gather(out, t.contiguous(), group=self.pg)
        return out

    def all_gather_object(self, obj) -> list:
        out = [None] * self.size
        tdist.all_gather_object(out, obj, group=self.pg)
        return out

    def mesh_groups(self, data: int, model: int) -> tuple:
        """(this rank's data group, its model group) of a ``data`` x
        ``model`` mesh over this group; every rank makes every subgroup,
        in one order, once per shape."""
        key = (data, model)
        if key not in self._mesh_groups:
            self._mesh_groups[key] = _subgroups(
                self.rank, data, model,
                lambda ranks: ProcessGroup(tdist.new_group(ranks)))
        return self._mesh_groups[key]


def _subgroups(rank: int, data: int, model: int, make) -> tuple:
    """Make the ``model`` data groups (ranks m, M + m, ...), then the
    ``data`` model groups (ranks d M, ..., d M + M - 1), each with
    ``make(ranks)``; return the two that hold ``rank``."""
    d, m = divmod(rank, model)
    data_groups = [make([i * model + j for i in range(data)]) for j in range(model)]
    model_groups = [make([i * model + j for j in range(model)]) for i in range(data)]
    return data_groups[m], model_groups[d]


_PROCESS_GROUP = ProcessGroup()
_local = threading.local()
_UNSET = object()  # no group installed on this thread
AXES = ("data", "model")


def world():
    """Every rank of the run: a :class:`ThreadRanks` thread's simulated
    world, else the process group when one is up, else None (one rank)."""
    installed = getattr(_local, "groups", _UNSET)
    if installed is not _UNSET and "world" in installed:
        return installed["world"]
    if tdist.is_available() and tdist.is_initialized():
        return _PROCESS_GROUP
    return None


def group(axis_name: str = "data"):
    """The calling thread's group along ``axis_name``: the one installed by
    :func:`use_group` (``None``: one rank), else the world for ``data``
    and None for ``model``."""
    installed = getattr(_local, "groups", _UNSET)
    if installed is not _UNSET:
        return installed.get(axis_name)
    return world() if axis_name == "data" else None


def mesh_groups(base, data: int, model: int) -> tuple:
    """(data group, model group) of a ``data`` x ``model`` mesh over the
    group ``base`` (None: one rank): an axis of 1 has no group, an axis
    that spans ``base`` is ``base`` itself, and a 2-D mesh makes its
    subgroups."""
    if base is None or model == 1:
        return base, None
    if data == 1:
        return None, base
    return base.mesh_groups(data, model)


@contextlib.contextmanager
def use_group(g, model=None):
    """Run the block with ``g`` as this thread's ``data`` group and
    ``model`` as its ``model`` group (each with ``size``, ``rank``,
    ``all_reduce_sum_``, ...; ``None`` for one rank)."""
    old = getattr(_local, "groups", _UNSET)
    _local.groups = {"data": g, "model": model}
    if old is not _UNSET and "world" in old:
        _local.groups["world"] = old["world"]
    try:
        yield g
    finally:
        if old is _UNSET:
            del _local.groups
        else:
            _local.groups = old


def _check_axis(axis_name: str) -> None:
    if axis_name not in AXES:
        raise NotImplementedError(
            f"collectives over mesh axis {axis_name!r} wait for the port's "
            "sequence, expert and pipeline axes (A8b); the port has 'data' and 'model'"
        )


def axis_size(axis_name: str = "data") -> int:
    """Ranks along the axis (1 without a group)."""
    _check_axis(axis_name)
    g = group(axis_name)
    return g.size if g is not None else 1


def axis_index(axis_name: str = "data") -> int:
    """This rank's position along the axis (0 without a group)."""
    _check_axis(axis_name)
    g = group(axis_name)
    return g.rank if g is not None else 0


def _count(tag: str, t: torch.Tensor, t0: float) -> None:
    TRAFFIC[f"{tag}_seconds"] += time.perf_counter() - t0
    TRAFFIC[f"{tag}_calls"] += 1
    TRAFFIC[f"{tag}_bytes"] += t.numel() * t.element_size()


def all_reduce_sum_(t: torch.Tensor, *, tag: str = "other",
                    axis_name: str = "data") -> torch.Tensor:
    """Sum ``t`` over the axis's ranks, in place, outside autograd;
    returns ``t``."""
    g = group(axis_name)
    if g is not None:
        t0 = time.perf_counter()
        g.all_reduce_sum_(t)
        _count(tag, t, t0)
    return t


def all_reduce_max_(t: torch.Tensor, *, tag: str = "other",
                    axis_name: str = "model") -> torch.Tensor:
    """The elementwise max of ``t`` over the axis's ranks, in place,
    outside autograd; returns ``t``."""
    g = group(axis_name)
    if g is not None:
        t0 = time.perf_counter()
        g.all_reduce_max_(t)
        _count(tag, t, t0)
    return t


def all_gather(t: torch.Tensor, dim: int, *, axis_name: str, tag: str = "other"):
    """The ranks' ``t`` concatenated along ``dim`` in axis order, outside
    autograd (``t`` itself without a group)."""
    g = group(axis_name)
    if g is None:
        return t
    t0 = time.perf_counter()
    parts = g.all_gather(t.detach())
    _count(tag, t, t0)
    return torch.cat(parts, dim=dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        gx = gy.detach().clone()
        with use_group(None, model=ctx.g):
            return all_reduce_sum_(gx, tag="model_bwd", axis_name="model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        y = x.detach().clone()
        with use_group(None, model=g):
            return all_reduce_sum_(y, tag="model_fwd", axis_name="model")

    @staticmethod
    def backward(ctx, gy):
        return gy, None


def copy_to_model(t: torch.Tensor) -> torch.Tensor:
    """``t`` unchanged; its gradient summed over the ``model`` axis (each
    model rank's backward reaches ``t`` through its own row block)."""
    g = group("model")
    return t if g is None else _CopyToModel.apply(t, g)


def reduce_from_model(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ``model`` axis; the gradient passes through
    unchanged (the loss after it is replicated over ``model``)."""
    g = group("model")
    return t if g is None else _ReduceFromModel.apply(t, g)


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
    g = group(axis_name)
    if g is None:
        return t
    return _PSum.apply(t, g, tag)


def pmean(t: torch.Tensor, axis_name: str = "data", *, tag: str = "other") -> torch.Tensor:
    """``t`` averaged over the axis (differentiable)."""
    return psum(t, axis_name, tag=tag) / axis_size(axis_name)


def all_gather_object(obj, axis_name: str = "data") -> list:
    """Every rank's ``obj`` along the axis, in rank order (``[obj]`` on
    one rank)."""
    g = group(axis_name)
    return g.all_gather_object(obj) if g is not None else [obj]


class ThreadRanks:
    """``n`` simulated ranks as threads of this process: :meth:`run`
    calls ``fn(rank)`` in each under a data group whose all-reduce sums
    the ranks' tensors in rank order (every rank gets the same bits).
    ``build_mesh`` under it makes 2-D meshes' subgroups from the same
    threads (:meth:`sub`)."""

    def __init__(self, n: int, *, timeout: float = 60.0):
        self.size = n
        self.timeout = timeout
        self._barrier = threading.Barrier(n, timeout=timeout)
        self._slots: list = [None] * n
        self._subs: dict = {}
        self._lock = threading.Lock()

    def _exchange(self, rank: int, value) -> list:
        self._slots[rank] = value
        self._barrier.wait()
        out = list(self._slots)
        self._barrier.wait()  # nobody overwrites a slot before all have read
        return out

    def sub(self, members: tuple) -> "ThreadRanks":
        """The simulated subgroup of the threads ``members`` (one object
        for every member)."""
        with self._lock:
            if members not in self._subs:
                self._subs[members] = ThreadRanks(len(members), timeout=self.timeout)
            return self._subs[members]

    def _abort(self) -> None:
        self._barrier.abort()
        with self._lock:
            subs = list(self._subs.values())
        for s in subs:
            s._abort()

    def run(self, fn) -> list:
        """``[fn(0), ..., fn(n - 1)]``, each on its own thread; re-raises
        the first rank's exception."""
        results: list = [None] * self.size
        errors: list = [None] * self.size

        def body(rank):
            try:
                me = _ThreadRank(self, rank)
                _local.groups = {"world": me, "data": me, "model": None}
                results[rank] = fn(rank)
            except BaseException as e:  # handed to the caller below
                errors[rank] = e
                self._abort()

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

    def _reduce(self, t: torch.Tensor, op) -> None:
        parts = self.ranks._exchange(self.rank, t.detach().clone())
        total = parts[0].clone()
        for part in parts[1:]:
            total = op(total, part)
        t.copy_(total)

    def all_reduce_sum_(self, t: torch.Tensor) -> None:
        self._reduce(t, torch.add)

    def all_reduce_max_(self, t: torch.Tensor) -> None:
        self._reduce(t, torch.maximum)

    def all_gather(self, t: torch.Tensor) -> list:
        return self.ranks._exchange(self.rank, t.detach().clone())

    def all_gather_object(self, obj) -> list:
        return self.ranks._exchange(self.rank, obj)

    def mesh_groups(self, data: int, model: int) -> tuple:
        def make(members):
            if self.rank not in members:
                return None
            return _ThreadRank(self.ranks.sub(tuple(members)), members.index(self.rank))

        return _subgroups(self.rank, data, model, make)
