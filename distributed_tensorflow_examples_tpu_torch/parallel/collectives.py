"""Collectives over the mesh's axes: the port of
``distributed_tensorflow_examples_tpu/parallel/collectives.py`` and of
the collectives that data, expert, sequence, tensor and pipeline
parallelism use.

In the JAX package GSPMD emits the all-reduces of a sharded step, and a
``shard_map`` region runs its own; here they are explicit.  Each axis
is a group of ranks.  The world's rank r sits at ``(slice, data, pipe,
expert, seq, model)`` in the JAX ``DEFAULT_AXES`` order, ``model``
innermost.  An axis's group is the ranks that differ only in that
axis's index.  :func:`mesh_groups` makes them
(``torch.distributed.new_group``, called by every rank in one order; an
axis that spans the world is the world itself, and an axis of 1 has no
group), with three more: the ``batch`` group, the slice x data x expert
x seq ranks over which the train step averages its gradients (each
holds its own tokens of the global batch: rows over slice x data x
expert, a slice of the sequence over seq; the pipe ranks of one row
shard hold the same rows and their own layers), the ``expert_grad``
group, the slice x data x seq ranks of one expert index, over which an
expert-sharded leaf's gradient sums, and the ``rows`` group, the slice
x data x expert ranks that hold the batch's row shards (global
BatchNorm statistics and ZeRO-1's chunks).  ``build_mesh`` attaches
them to the mesh.  Code reads an axis's group from the calling thread:
``build_train_step`` installs its mesh's groups for the whole step
(:func:`use_group`), so the step, SyncBN, plain BN, the LSTM's dropout
rows, the vocab-parallel layers, the sequence-parallel attention, the
experts and the pipeline all read the same ones, and code outside a
step (the input streams, the checkpoint, evaluation) runs under
``Mesh.axes()``, which installs them likewise.  With none installed
the ``data``, ``rows`` and ``batch`` axes are the world (the process
group, or one rank) and the others one rank.

:func:`axis_size` and :func:`axis_index` are an axis's size and this
rank's place on it (over a tuple of axes, as ``lax.axis_index`` takes
one, their product, the first axis major: ``("slice", "data",
"expert")`` is the batch rows' shards); :func:`psum` sums a tensor over
an axis with autograd (its backward sums the cotangent likewise, as
JAX's ``psum`` transposes); :func:`all_reduce_sum_` sums in place
without autograd (gradients, SyncBN's partial sums).  The two operators
a vocab-parallel or Megatron layer needs, and GSPMD derives by itself:
:func:`copy_to_model`, the identity forward and a sum over ``model``
backward (an activation that enters a column- or row-sharded product),
and :func:`reduce_from_model`, a sum over ``model`` forward and the
identity backward (the partial results of the row blocks).  ``psum`` is
neither: the loss after a lookup is replicated over ``model``, so its
backward would scale the table gradient by M.  The pipeline's pair is
the same two over ``pipe`` (:func:`copy_to_axis`,
:func:`reduce_from_axis`): the stack's input, replicated over pipe and
consumed by the first stage alone, takes its cotangent summed over the
axis (the transpose of JAX's ``P()`` ``shard_map`` input), and the last
stage's output, broadcast by a masked sum, passes its cotangent
through.  The sequence axis's two (JAX ``ring_permute`` and
``lax.all_to_all``): :func:`ring_permute` sends to the rank ``shift``
hops around the axis and receives from the one ``shift`` hops back (one
``batch_isend_irecv`` pair, so a ring of any size cannot deadlock), its
backward the permutation by ``-shift``; the pipeline hands a stage's
output to the next stage with it, over ``pipe``; :func:`all_to_all`
splits a tensor into one tile per rank along one dim and concatenates
what it receives along another, its backward the all-to-all back, both
made of point-to-point sends and receives.  gloo has none for CUDA
tensors, so on gloo (ranks sharing a card) a CUDA tensor crosses
through a pinned host copy; on nccl it goes direct.  Without a group
every one of them is the identity on one rank.  :class:`ThreadRanks`
runs simulated ranks as threads of one process (the twin of the JAX
package's ``local_mesh_for_testing``); a mesh built on them makes its
groups from the same threads.  ``TRAFFIC`` counts the calls, bytes and
host seconds of each tag (the seconds a call holds the host: the whole
exchange on gloo, the enqueue on nccl); the model axis's sums count
under ``model_fwd`` (forward) and ``model_bwd`` (backward), the ring's
permutations under ``seq_ring`` and the all-to-alls under ``seq_a2a``
(the bytes of the tiles sent to the other ranks: a rank's own tile
stays where it is), the experts' all-to-alls under ``expert_a2a``, the
pipeline's stage handoffs under ``pipe`` and its output broadcast under
``pipe_out``.  Beside ``TRAFFIC``, every tensor collective is offered
to the calling rank's recorders (``utils/hlo_analysis.py``'s
``record_collectives``): one record a call, in XLA's names, with the
global ranks of the group that made it, so a record made on autograd's
thread (a custom backward holds its group) reaches the rank that owns
the group; ``all_gather_object`` moves a pickled host object and is not
recorded.
"""

from __future__ import annotations

import collections
import contextlib
import math
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

    #: Every ProcessGroup of a process is one rank's: one account key.
    account_key = "process"

    def __init__(self, pg=None):
        self.pg = pg
        self._axis_groups: dict = {}
        self._global_ranks: list | None = None

    @property
    def global_ranks(self) -> list:
        """The world ranks of this group's ranks, in group order."""
        if self._global_ranks is None:
            self._global_ranks = (list(range(tdist.get_world_size())) if self.pg is None
                                  else list(tdist.get_process_group_ranks(self.pg)))
        return self._global_ranks

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

    def _through_host(self, t: torch.Tensor) -> bool:
        """Whether ``t`` crosses through a host copy: a CUDA tensor on gloo,
        which has no point-to-point or all-to-all for CUDA tensors."""
        return t.is_cuda and tdist.get_backend(self.pg) == "gloo"

    def ring_permute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        """``t`` sent to rank ``(i + shift) % n``; the tensor of rank
        ``(i - shift) % n`` returned: one isend and one irecv, batched."""
        n, i = self.size, self.rank
        host = self._through_host(t)
        send = _pinned(t) if host else t.contiguous()
        recv = torch.empty_like(send)
        ops = [tdist.P2POp(tdist.isend, send, self._peer((i + shift) % n), self.pg),
               tdist.P2POp(tdist.irecv, recv, self._peer((i - shift) % n), self.pg)]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(t.device, non_blocking=True) if host else recv

    def all_to_all(self, tiles: list) -> list:
        """``tiles[j]`` sent to rank j; the tiles the ranks sent here, in
        rank order: one batch of point-to-point sends and receives, a pair
        for each other rank (gloo has no all-to-all in every torch
        release)."""
        n, i = self.size, self.rank
        host = self._through_host(tiles[0])
        ops, out = [], list(tiles)
        for j in range(n):
            if j != i:
                send = _pinned(tiles[j]) if host else tiles[j].contiguous()
                out[j] = torch.empty_like(send)
                ops += [tdist.P2POp(tdist.isend, send, self._peer(j), self.pg),
                        tdist.P2POp(tdist.irecv, out[j], self._peer(j), self.pg)]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        if host:
            out = [x if j == i else x.to(tiles[i].device, non_blocking=True)
                   for j, x in enumerate(out)]
        return out

    def _peer(self, r: int) -> int:
        """The world rank of this group's rank ``r``."""
        return r if self.pg is None else tdist.get_global_rank(self.pg, r)

    def axis_group(self, shape: tuple, varying: tuple):
        """This rank's group among the ranks of a ``shape`` mesh over this
        group that differ only in the axes ``varying`` (:func:`_axis_group`);
        every rank makes every such subgroup, in one order, once per
        shape."""
        key = (shape, varying)
        if key not in self._axis_groups:
            self._axis_groups[key] = _axis_group(
                self.rank, shape, varying,
                lambda ranks: ProcessGroup(tdist.new_group(ranks)))
        return self._axis_groups[key]


def _pinned(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _coords(rank: int, shape: tuple) -> tuple:
    """The coordinates of ``rank`` on a mesh of ``shape`` (the axes'
    sizes, outermost first; the last axis innermost)."""
    out = []
    for n in reversed(shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def _axis_group(rank: int, shape: tuple, varying: tuple, make):
    """Make, with ``make(ranks)``, every group of the ranks of a ``shape``
    mesh (the axes' sizes in ``AXES`` order) that share their indices outside
    the axes ``varying`` (positions into ``shape``), in the order of their
    lowest rank, each group's ranks ascending; return the one that holds
    ``rank``."""
    groups: dict = {}
    for r in range(math.prod(shape)):
        c = _coords(r, shape)
        groups.setdefault(tuple(x for a, x in enumerate(c) if a not in varying), []).append(r)
    made = {key: make(ranks) for key, ranks in groups.items()}
    mine = _coords(rank, shape)
    return made[tuple(x for a, x in enumerate(mine) if a not in varying)]


_PROCESS_GROUP = ProcessGroup()
_local = threading.local()
_UNSET = object()  # no group installed on this thread
AXES = ("slice", "data", "pipe", "expert", "seq", "model")
#: The axes, and the groups over more than one of them that code reads:
#: ``batch`` (slice x data x expert x seq), ``expert_grad`` (slice x data
#: x seq) and ``rows`` (slice x data x expert).
GROUPS = AXES + ("batch", "expert_grad", "rows")
#: The groups that are the world when no group is installed.
_WORLD_GROUPS = ("data", "batch", "rows")


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
    """The calling thread's group along ``axis_name`` (an axis or one of
    ``GROUPS``): the one installed by :func:`use_group` (``None``: one
    rank), else the world for ``data``, ``rows`` and ``batch`` and None
    for the others."""
    installed = getattr(_local, "groups", _UNSET)
    if installed is not _UNSET:
        return installed.get(axis_name)
    return world() if axis_name in _WORLD_GROUPS else None


def mesh_groups(base, sizes: dict) -> dict:
    """The groups of a mesh of ``sizes`` (axis -> size, every axis of
    ``AXES``) over the group ``base`` (None: one rank), by name: one per
    axis, then ``batch`` (slice x data x expert x seq), ``expert_grad``
    (slice x data x seq, None without an expert axis) and ``rows`` (slice
    x data x expert).  The data group is ``base`` when it spans it (a
    world of one too); any other group of one rank is None, a group that
    spans ``base`` is ``base`` itself, and the others are subgroups; a
    group over the data axis and axes of 1 is the data group (so a world
    of one still sums its gradients over itself)."""
    n = 1 if base is None else base.size
    shape = tuple(sizes[a] for a in AXES)
    made: dict = {}

    def over(names: tuple):
        if "data" in names and all(sizes[a] == 1 for a in names if a != "data"):
            return data_g
        varying = tuple(AXES.index(a) for a in names if sizes[a] > 1)
        size = math.prod(shape[a] for a in varying)
        if size == 1:
            return None
        if size == n:
            return base
        if varying not in made:
            made[varying] = base.axis_group(shape, varying)
        return made[varying]

    data_g = None
    if sizes["data"] == n:
        data_g = base
    elif sizes["data"] > 1:
        data_g = base.axis_group(shape, (AXES.index("data"),))
    out = {a: over((a,)) for a in AXES}
    out["data"] = data_g
    out["batch"] = over(("slice", "data", "expert", "seq"))
    out["expert_grad"] = over(("slice", "data", "seq")) if sizes["expert"] > 1 else None
    out["rows"] = over(("slice", "data", "expert"))
    return out


@contextlib.contextmanager
def use_group(g, model=None, seq=None, expert=None, batch=_UNSET, expert_grad=None, *,
              pipe=None, slice=None, rows=_UNSET):
    """Run the block with ``g`` as this thread's ``data`` group and the
    others as theirs (each with ``size``, ``rank``, ``all_reduce_sum_``,
    ...; ``None`` for one rank): ``model``, ``seq``, ``expert``, ``pipe``
    and ``slice`` an axis each, ``batch``, ``expert_grad`` and ``rows``
    (``GROUPS``) likewise, the batch and rows groups ``g`` unless
    given."""
    old = getattr(_local, "groups", _UNSET)
    _local.groups = {"data": g, "model": model, "seq": seq, "expert": expert,
                     "pipe": pipe, "slice": slice,
                     "batch": g if batch is _UNSET else batch, "expert_grad": expert_grad,
                     "rows": g if rows is _UNSET else rows}
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
    if axis_name not in GROUPS:
        raise ValueError(f"unknown mesh axis or group {axis_name!r}; valid: {GROUPS}")


def axis_size(axis_name="data") -> int:
    """Ranks along the axis, or the product over a tuple of axes (1
    without a group)."""
    if isinstance(axis_name, tuple):
        return math.prod(axis_size(a) for a in axis_name)
    _check_axis(axis_name)
    g = group(axis_name)
    return g.size if g is not None else 1


def axis_index(axis_name="data") -> int:
    """This rank's position along the axis (0 without a group); over a
    tuple of axes, the position in their product, the first axis major
    (JAX's ``lax.axis_index`` of a tuple)."""
    if isinstance(axis_name, tuple):
        index = 0
        for a in axis_name:
            index = index * axis_size(a) + axis_index(a)
        return index
    _check_axis(axis_name)
    g = group(axis_name)
    return g.rank if g is not None else 0


def _count(tag: str, t: torch.Tensor, t0: float, nbytes: int | None = None) -> None:
    """One call of ``tag``: its host seconds since ``t0`` and the bytes it
    sent (``t``'s whole size unless ``nbytes`` says otherwise)."""
    TRAFFIC[f"{tag}_seconds"] += time.perf_counter() - t0
    TRAFFIC[f"{tag}_calls"] += 1
    TRAFFIC[f"{tag}_bytes"] += t.numel() * t.element_size() if nbytes is None else nbytes


#: Each rank's collective recorders, by the account key of its groups:
#: ``sink(kind, shapes, nbytes, tag, groups)`` callables
#: (``utils/hlo_analysis.py::record_collectives`` adds and removes them).
RECORDERS: dict = {}
_HLO_TYPES = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.int64: "s64", torch.int32: "s32",
              torch.int16: "s16", torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


def account_key():
    """The key of the calling thread's rank in ``RECORDERS``: its
    :class:`ThreadRanks` rank's, else the process's."""
    w = world()
    return ProcessGroup.account_key if w is None else w.account_key


def _record(g, kind: str, tag: str, t: torch.Tensor, *, shape=None, parts=None,
            shift: int | None = None) -> None:
    """Offer one call over the group ``g`` to the recorders of the rank
    that owns ``g`` (whichever thread runs it): XLA's ``kind``, the HLO
    shape of ``t`` (or ``shape``, a gather's result), or of each of the
    ``parts`` a flat bucket packs (XLA's variadic all-reduce), the bytes
    of that shape (the payload, the gathered result, the whole tensor of
    an all-to-all), and the group's global ranks (a permutation's
    source-target pairs, each rank sending ``shift`` hops on)."""
    sinks = RECORDERS.get(g.account_key)
    if not sinks:
        return
    dims = tuple(t.shape) if shape is None else tuple(shape)
    hlo = _HLO_TYPES.get(t.dtype, str(t.dtype))
    shapes = [f"{hlo}[{','.join(map(str, d))}]" for d in (parts or [dims])]
    members = list(g.global_ranks)
    n = len(members)
    groups = ([members] if shift is None
              else [[members[i], members[(i + shift) % n]] for i in range(n)])
    for sink in list(sinks):
        sink(kind, shapes, math.prod(dims) * t.element_size(), tag, groups)


def all_reduce_sum_(t: torch.Tensor, *, tag: str = "other",
                    axis_name: str = "data") -> torch.Tensor:
    """Sum ``t`` over the axis's ranks, in place, outside autograd;
    returns ``t``."""
    g = group(axis_name)
    if g is not None:
        t0 = time.perf_counter()
        g.all_reduce_sum_(t)
        _count(tag, t, t0)
        _record(g, "all-reduce", tag, t, parts=getattr(_local, "parts", None))
    return t


@contextlib.contextmanager
def bucket(parts: list):
    """The block's :func:`all_reduce_sum_` sums a flat bucket of tensors of
    the shapes ``parts``: the account records it as XLA's variadic
    all-reduce, a shape for each."""
    old = getattr(_local, "parts", None)
    _local.parts = parts
    try:
        yield
    finally:
        _local.parts = old


def all_reduce_max_(t: torch.Tensor, *, tag: str = "other",
                    axis_name: str = "model") -> torch.Tensor:
    """The elementwise max of ``t`` over the axis's ranks, in place,
    outside autograd; returns ``t``."""
    g = group(axis_name)
    if g is not None:
        t0 = time.perf_counter()
        g.all_reduce_max_(t)
        _count(tag, t, t0)
        _record(g, "all-reduce", tag, t)
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
    _record(g, "all-gather", tag, t, shape=_gathered(t, dim, g.size))
    return torch.cat(parts, dim=dim)


def _gathered(t: torch.Tensor, dim: int, n: int) -> tuple:
    """The shape of ``n`` ranks' ``t`` concatenated along ``dim``."""
    shape = list(t.shape)
    shape[dim] *= n
    return tuple(shape)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim, tag):
        ctx.g, ctx.dim, ctx.tag, ctx.size = g, dim, tag, x.shape[dim]
        t0 = time.perf_counter()
        parts = g.all_gather(x.detach().contiguous())
        _count(tag, x, t0)
        _record(g, "all-gather", tag, x, shape=_gathered(x, dim, g.size))
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, gy):
        gx = gy.detach().contiguous().clone()
        with use_group(ctx.g):
            all_reduce_sum_(gx, tag=ctx.tag)
        return gx.narrow(ctx.dim, ctx.g.rank * ctx.size, ctx.size), None, None, None


def gather_blocks(t: torch.Tensor, dim: int, axis_name: str, *, tag: str = "other"):
    """The ranks' ``t`` concatenated along ``dim`` in axis order,
    differentiable: a rank's gradient is its block of the cotangents
    summed over the axis (JAX's ``all_gather`` transposes to a
    ``psum_scatter``).  ``t`` itself without a group."""
    _check_axis(axis_name)
    g = group(axis_name)
    return t if g is None else _GatherBlocks.apply(t, g, dim, tag)


def _sum_over(g, t: torch.Tensor, tag: str) -> torch.Tensor:
    """``t`` summed over the group ``g`` in place, counted under ``tag``."""
    t0 = time.perf_counter()
    g.all_reduce_sum_(t)
    _count(tag, t, t0)
    _record(g, "all-reduce", tag, t)
    return t


class _CopyToAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, tag):
        ctx.g, ctx.tag = g, tag
        return x.view_as(x)

    @staticmethod
    def backward(ctx, gy):
        return _sum_over(ctx.g, gy.detach().clone(), ctx.tag), None, None


class _ReduceFromAxis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, tag):
        return _sum_over(g, x.detach().clone(), tag)

    @staticmethod
    def backward(ctx, gy):
        return gy, None, None


def copy_to_axis(t: torch.Tensor, axis_name: str, *, tag: str) -> torch.Tensor:
    """``t`` unchanged; its gradient summed over the axis (each rank's
    backward reaches ``t`` through its own part of the work).  ``t``
    itself without a group."""
    _check_axis(axis_name)
    g = group(axis_name)
    return t if g is None else _CopyToAxis.apply(t, g, tag)


def reduce_from_axis(t: torch.Tensor, axis_name: str, *, tag: str) -> torch.Tensor:
    """``t`` summed over the axis; the gradient passes through unchanged
    (what follows is replicated over the axis).  ``t`` itself without a
    group."""
    _check_axis(axis_name)
    g = group(axis_name)
    return t if g is None else _ReduceFromAxis.apply(t, g, tag)


def copy_to_model(t: torch.Tensor) -> torch.Tensor:
    """``t`` unchanged; its gradient summed over the ``model`` axis (each
    model rank's backward reaches ``t`` through its own row block)."""
    return copy_to_axis(t, "model", tag="model_bwd")


def reduce_from_model(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ``model`` axis; the gradient passes through
    unchanged (the loss after it is replicated over ``model``)."""
    return reduce_from_axis(t, "model", tag="model_fwd")


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


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, shift, tag):
        ctx.g, ctx.shift, ctx.tag = g, shift, tag
        return permute_over(g, x, shift=shift, tag=tag)

    @staticmethod
    def backward(ctx, gy):
        return permute_over(ctx.g, gy, shift=-ctx.shift, tag=ctx.tag), None, None, None


def permute_over(g, x: torch.Tensor, *, shift: int, tag: str = "seq_ring") -> torch.Tensor:
    """:func:`ring_permute` over the group ``g`` (None: one rank, ``x``
    itself), outside autograd: for a backward, which runs on autograd's
    thread and sees no installed group."""
    if g is None:
        return x
    t0 = time.perf_counter()
    y = g.ring_permute(x.detach(), shift)
    _count(tag, x, t0)
    _record(g, "collective-permute", tag, x, shift=shift)
    return y


def ring_permute(x: torch.Tensor, axis_name: str = "seq", *, shift: int = 1,
                 tag: str = "seq_ring") -> torch.Tensor:
    """``x`` sent to the rank ``shift`` hops around the axis, the tensor of
    the rank ``shift`` hops back received (JAX ``ring_permute``'s perm:
    rank i sends to ``(i + shift) % n``), differentiable: the gradient
    travels back by ``-shift``.  The identity without a group."""
    _check_axis(axis_name)
    g = group(axis_name)
    if g is None:
        return x
    return _RingPermute.apply(x, g, shift, tag)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split_dim, concat_dim, tag):
        ctx.g, ctx.dims, ctx.tag = g, (split_dim, concat_dim), tag
        return _all_to_all(g, x, split_dim, concat_dim, tag)

    @staticmethod
    def backward(ctx, gy):
        split_dim, concat_dim = ctx.dims
        return _all_to_all(ctx.g, gy, concat_dim, split_dim, ctx.tag), None, None, None, None


def _all_to_all(g, x: torch.Tensor, split_dim: int, concat_dim: int, tag: str):
    if x.shape[split_dim] % g.size:
        raise ValueError(
            f"all_to_all: dim {split_dim} of {tuple(x.shape)} does not split into "
            f"{g.size} tiles")
    t0 = time.perf_counter()
    parts = g.all_to_all(list(x.detach().chunk(g.size, dim=split_dim)))
    # This rank's own tile stays here: only the other ranks' tiles are sent.
    _count(tag, x, t0, x.numel() * x.element_size() * (g.size - 1) // g.size)
    _record(g, "all-to-all", tag, x)
    return torch.cat(parts, dim=concat_dim)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, axis_name: str = "seq", *,
               tag: str = "seq_a2a") -> torch.Tensor:
    """JAX ``lax.all_to_all(..., tiled=True)``: ``x`` cut into one tile per
    rank of the axis along ``split_dim``, tile j sent to rank j, and the
    tiles received concatenated along ``concat_dim`` in rank order;
    differentiable (the gradient goes through the all-to-all back).  The
    identity without a group."""
    _check_axis(axis_name)
    g = group(axis_name)
    if g is None:
        return x
    return _AllToAll.apply(x, g, split_dim, concat_dim, tag)


def all_gather_object(obj, axis_name: str = "data") -> list:
    """Every rank's ``obj`` along the axis, in rank order (``[obj]`` on
    one rank).  A pickled host object: neither counted in ``TRAFFIC`` nor
    recorded."""
    g = group(axis_name)
    return g.all_gather_object(obj) if g is not None else [obj]


class ThreadRanks:
    """``n`` simulated ranks as threads of this process: :meth:`run`
    calls ``fn(rank)`` in each under a data group whose all-reduce sums
    the ranks' tensors in rank order (every rank gets the same bits).
    ``build_mesh`` under it makes 2-D meshes' subgroups from the same
    threads (:meth:`sub`)."""

    def __init__(self, n: int, *, timeout: float = 60.0, root: "ThreadRanks | None" = None,
                 members: tuple | None = None):
        self.size = n
        self.timeout = timeout
        self.root = self if root is None else root
        #: The root's ranks (the simulated world's) of this one's ranks.
        self.members = tuple(range(n)) if members is None else members
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
                self._subs[members] = ThreadRanks(
                    len(members), timeout=self.timeout, root=self.root,
                    members=tuple(self.members[m] for m in members))
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
                _local.groups = {"world": me, "data": me, "batch": me, "rows": me}
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
        self.global_ranks = ranks.members
        self.account_key = (id(ranks.root), ranks.members[rank])

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

    def ring_permute(self, t: torch.Tensor, shift: int) -> torch.Tensor:
        parts = self.ranks._exchange(self.rank, t.detach().clone())
        return parts[(self.rank - shift) % self.size].clone()

    def all_to_all(self, tiles: list) -> list:
        parts = self.ranks._exchange(self.rank, [x.detach().clone() for x in tiles])
        return [parts[j][self.rank].clone() for j in range(self.size)]

    def axis_group(self, shape: tuple, varying: tuple):
        def make(members):
            if self.rank not in members:
                return None
            return _ThreadRank(self.ranks.sub(tuple(members)), members.index(self.rank))

        return _axis_group(self.rank, shape, varying, make)
