"""The examples' optimizers, with optax's formulas.

The JAX package builds ``optax.chain(optax.clip_by_global_norm(clip_norm),
optax.adamw(learning_rate))``.  :class:`ClippedAdamW` is the same update
as a hand-written clip followed by ``torch.optim.AdamW``:

- the clip is optax's ``where(norm < max, g, g / norm * max)``, with no
  ``+1e-6`` in the denominator (``torch.nn.utils.clip_grad_norm_`` adds
  one), chosen on the device with no host sync;
- AdamW takes optax's settings: b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, bias correction, and weight decay 1e-4 on every leaf
  (torch defaults to 1e-2).  torch decays ``p *= 1 - lr * wd`` before
  the Adam step; optax adds ``wd * p`` to the Adam update; both read the
  old ``p``, so the two are the same formula in another order.  It runs
  fused (one kernel for every leaf).

The optimizer state is the ``torch.optim.AdamW`` itself: it holds the
parameter tensors, which the train step updates in place.

:class:`SGD` is ``optax.sgd(schedule, momentum)`` (ResNet-50's optimizer):
``optax.trace`` (buf = g + momentum * buf, from zeros; no dampening, no
Nesterov) scaled by the learning rate, which is ``torch.optim.SGD`` with
the rate of update k set from the schedule before the update.  k is the
train step's count of updates so far, not a counter of the optimizer's own,
so a resumed run reads the right rate.  With ``clip_norm`` it is
``optax.chain(clip_by_global_norm(clip_norm), sgd(...))`` (the PTB
LSTM's optimizer), the clip the one :class:`ClippedAdamW` takes.
:func:`piecewise_constant_schedule` and :func:`linear_schedule` are
optax's, in float32 as optax computes them.

Both run fused (one kernel for every leaf) and share ``init(params) ->
opt_state`` and ``update(opt_state, params, step)``.

Sharded leaves (``train/state.py::create_sharded_state``) take a
:class:`ShardedOptState` in place of the torch optimizer.  A leaf sharded
over ``model`` (a vocab-parallel table) holds this rank's rows, and so do
its slots.  A ZeRO-1 leaf (``--zero_opt``, JAX ``_zero_shard_opt``) is
replicated, but its slots hold only this rank's 1/D of it (D the data
degree): the step's gradient all-reduce is followed by a slice (an
all-reduce and a slice, not a reduce-scatter: gloo has none), the torch
optimizer updates this rank's chunk of the parameter in place, through a
view, and an all-gather of the chunks rebuilds the rest of the
parameter, so the numbers are the replicated step's (the update is
elementwise).  An expert leaf (``ops/moe.py``'s rules) holds this rank's
experts over ``expert``, and a stacked leaf (a pipelined model's blocks)
this rank's layers over ``pipe``, and so do their slots; on an expert
mesh ZeRO-1's chunks are over the row shards (data x expert), whose
ranks all hold the replicated leaves.  The chunk is the rank's contiguous 1/D of the leaf's
elements, not its block along the dim the JAX rule names: torch's fused
optimizers read a strided view as if it were dense, and so update the
wrong elements of a block along an inner dim.  The rule still decides
which leaves are sharded, and a checkpoint holds the global slots.  The clip
takes the global norm over the global gradient: a leaf sharded over
``pipe``, ``expert`` or ``model`` has its squares summed over those
groups, every other leaf counts once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..parallel import collectives
from .state import leaves

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


def clip_by_global_norm_(grads: list, max_norm: float, sharded=None) -> None:
    """Scale ``grads`` in place by ``max_norm / norm`` when their global
    norm (f32) is at or above ``max_norm``; below it they are unchanged.
    ``sharded[i]``: the axes (``"pipe"``, ``"expert"``, ``"model"``) over which
    grads[i] is this rank's block, whose groups sum its squares."""
    norms = torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in grads])
    if sharded is not None and any(sharded):
        sq = norms * norms
        zeros = torch.zeros_like(sq)
        total = torch.where(torch.tensor([not a for a in sharded], device=sq.device),
                            sq, zeros).sum()
        for axes in sorted({tuple(a) for a in sharded if a}):
            mask = torch.tensor([tuple(a) == axes for a in sharded], device=sq.device)
            part = torch.where(mask, sq, zeros).sum().reshape(1)
            for axis in axes:
                collectives.all_reduce_sum_(part, tag=f"{axis}_clip", axis_name=axis)
            total = total + part[0]
        norm = torch.sqrt(total)
    else:
        norm = torch.linalg.vector_norm(norms)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)


class ClippedAdamW:
    """``init(params) -> opt_state``; ``update(opt_state, params)`` clips the
    leaves' ``.grad`` and steps the parameters in place."""

    def __init__(self, learning_rate: float, clip_norm: float):
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm

    def init(self, params) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            _as_list(params), lr=self.learning_rate, betas=(B1, B2), eps=EPS,
            weight_decay=WEIGHT_DECAY, fused=True,
        )

    @torch.no_grad()
    def update(self, opt_state: torch.optim.AdamW, params, step: int | None = None) -> None:
        """``step`` is unused: AdamW's own count, saved with its state,
        drives the bias correction."""
        ps = _grads_or_zeros(params)
        clip_by_global_norm_([p.grad for p in ps], self.clip_norm,
                             getattr(opt_state, "sharded_axes", None))
        opt_state.step()


def _as_list(params) -> list:
    """A list of leaves as it is, or the leaves of a params tree."""
    return list(params) if isinstance(params, list) else leaves(params)


def _grads_or_zeros(params) -> list:
    """The leaves, each with a ``.grad`` (zeros where autograd left none:
    optax moves every leaf, a zero gradient too)."""
    ps = leaves(params)
    for p in ps:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return ps


def piecewise_constant_schedule(init_value: float, boundaries_and_scales=None):
    """optax's ``piecewise_constant_schedule``: ``schedule(count)`` is
    ``init_value`` times every scale whose boundary ``count`` has reached
    (``count >= boundary``; updates count from 0), in float32."""
    items = sorted((int(b), np.float32(s)) for b, s in (boundaries_and_scales or {}).items())

    def schedule(count: int) -> float:
        if not items:  # optax hands the value back untouched
            return init_value
        v = np.float32(init_value)
        for boundary, scale in items:
            if count >= boundary:
                v = np.float32(scale * v)
        return float(v)

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    """optax's ``linear_schedule``: ``schedule(count)`` runs from
    ``init_value`` at count 0 to ``end_value`` at ``transition_steps`` and
    holds it after, in float32 operation for operation as optax evaluates
    it: ``(init - end) * (1 - clip(count) / steps) + end``."""
    if transition_steps <= 0:  # optax: a constant schedule
        return lambda _count: init_value
    span = np.float32(init_value - end_value)
    end = np.float32(end_value)
    steps = np.float32(transition_steps)

    def schedule(count: int) -> float:
        c = np.float32(min(max(int(count), 0), transition_steps))
        frac = np.float32(1.0) - np.float32(c / steps)
        return float(np.float32(span * frac) + end)

    return schedule


class SGD:
    """``optax.sgd(learning_rate, momentum)``: ``learning_rate`` a float or
    a ``schedule(count)``; ``clip_norm`` chains a global-norm clip before
    it."""

    def __init__(self, learning_rate, momentum: float = 0.0, clip_norm: float | None = None):
        self.schedule = learning_rate if callable(learning_rate) else (lambda _count: learning_rate)
        self.momentum = momentum
        self.clip_norm = clip_norm

    def init(self, params) -> torch.optim.SGD:
        return torch.optim.SGD(
            _as_list(params), lr=self.schedule(0), momentum=self.momentum,
            dampening=0.0, nesterov=False, fused=True,
        )

    @torch.no_grad()
    def update(self, opt_state: torch.optim.SGD, params, step: int) -> None:
        """Update number ``step`` (0 for the first) at ``schedule(step)``."""
        ps = _grads_or_zeros(params)
        if self.clip_norm is not None:
            clip_by_global_norm_([p.grad for p in ps], self.clip_norm,
                                 getattr(opt_state, "sharded_axes", None))
        lr = self.schedule(int(step))
        for group in opt_state.param_groups:
            group["lr"] = lr
        opt_state.step()


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one leaf is laid out: ``model_dim``, ``expert_dim`` and
    ``pipe_dim``, the dims of which this rank holds a block over ``model``,
    ``expert`` and ``pipe`` (the leaf and its slots; None: not sharded
    so); ``zero``, its slots hold this rank's chunk over the row shards
    (ZeRO-1)."""

    model_dim: int | None = None
    zero: bool = False
    expert_dim: int | None = None
    pipe_dim: int | None = None

    @property
    def dims(self) -> tuple:
        """(axis, dim) of every axis over which this rank holds a block."""
        return tuple((a, d) for a, d in (("pipe", self.pipe_dim), ("expert", self.expert_dim),
                                          ("model", self.model_dim)) if d is not None)

    @property
    def axes(self) -> tuple:
        """The axes over which this rank holds a block of the leaf."""
        return tuple(a for a, _d in self.dims)


def _block(t: torch.Tensor, dim: int, index: int, count: int) -> torch.Tensor:
    n = t.shape[dim] // count
    return t.narrow(dim, index * n, n)


def _chunk(t: torch.Tensor, index: int, count: int) -> torch.Tensor:
    """Chunk ``index`` of ``count`` of the contiguous ``t``'s elements, a
    view."""
    return _block(t.view(-1), 0, index, count)


class ShardedOptState:
    """The optimizer state of a run with sharded leaves (module
    docstring): the torch optimizer over the leaves, each ZeRO-1 leaf
    replaced by a view of this rank's chunk of it, so the optimizer holds
    no tensor of its own beyond the slots.  ``step()``,
    ``param_groups``, ``state_dict()`` and ``load_state_dict()`` stand in
    for the torch optimizer's; the state dicts hold the GLOBAL slots (the
    ranks' blocks gathered), the layout of the replicated optimizer, so a
    checkpoint moves between mesh shapes."""

    def __init__(self, optimizer, params, plan: list, *, data_group, model_group,
                 expert_group=None, pipe_group=None):
        self.plan = list(plan)
        self.data_group, self.model_group = data_group, model_group
        self.expert_group, self.pipe_group = expert_group, pipe_group
        self.params = leaves(params)
        self._data = (0, 1) if data_group is None else (data_group.rank, data_group.size)
        self._blocks = {a: (0, 1) if g is None else (g.rank, g.size)
                        for a, g in (("model", model_group), ("expert", expert_group),
                                     ("pipe", pipe_group))}
        #: leaf index -> the view of its chunk that the optimizer updates
        self.chunks = {i: _chunk(p.detach(), *self._data)
                       for i, (p, lp) in enumerate(zip(self.params, self.plan)) if lp.zero}
        self.inner = optimizer.init(
            [self.chunks.get(i, p) for i, p in enumerate(self.params)])

    @property
    def sharded_axes(self) -> list[tuple]:
        """Each leaf's ``LeafPlan.axes`` (the clip sums its squares over
        them)."""
        return [lp.axes for lp in self.plan]

    @property
    def expert_sharded(self) -> list[bool]:
        """Whether each leaf is this rank's block of experts (the step sums
        its gradient over the data x seq ranks only)."""
        return [lp.expert_dim is not None for lp in self.plan]

    @property
    def param_groups(self):
        return self.inner.param_groups

    def _groups(self):
        """The chunks' group as ``data``, and the block axes' groups."""
        return collectives.use_group(self.data_group, model=self.model_group,
                                     expert=self.expert_group, pipe=self.pipe_group)

    @torch.no_grad()
    def step(self) -> None:
        """Update every leaf from its ``.grad`` (the global gradient, after
        the step's all-reduce): a ZeRO-1 leaf's chunk in place, then the
        all-gather of the chunks into the leaf."""
        for i, chunk in self.chunks.items():
            chunk.grad = _chunk(self.params[i].grad, *self._data)
        self.inner.step()
        with self._groups():
            for i, chunk in self.chunks.items():
                self.params[i].view(-1).copy_(collectives.all_gather(
                    chunk, 0, axis_name="data", tag="zero_params"))

    def _slots(self, sd: dict, fn) -> dict:
        """``sd`` with ``fn(slot, leaf index)`` in place of every slot (a
        state tensor shaped like its leaf), in new dicts."""
        state = {}
        for i, slots in sd["state"].items():
            state[i] = {k: fn(v, int(i)) if torch.is_tensor(v) and v.dim() > 0 else v
                        for k, v in slots.items()}
        return {**sd, "state": state}

    def state_dict(self) -> dict:
        """The torch optimizer's state dict with every slot global (a
        collective: every rank calls it)."""

        def gather(v, i):
            lp, p = self.plan[i], self.params[i]
            with self._groups():
                if lp.zero:
                    v = collectives.all_gather(v, 0, axis_name="data", tag="ckpt").view(p.shape)
                for axis, dim in lp.dims:
                    v = collectives.all_gather(v, dim, axis_name=axis, tag="ckpt")
            return v

        return self._slots(self.inner.state_dict(), gather)

    def load_state_dict(self, sd: dict) -> None:
        """Load a state dict of global slots: each rank takes its blocks."""

        def take(v, i):
            lp = self.plan[i]
            for axis, dim in lp.dims:
                v = _block(v, dim, *self._blocks[axis])
            if lp.zero:
                v = _chunk(v.contiguous(), *self._data)
            return v.clone()  # the rank's own slot, not a view of the caller's

        self.inner.load_state_dict(self._slots(sd, take))


def state_bytes(opt_state) -> int:
    """The bytes of every tensor the optimizer holds on this rank beyond
    the model's parameters: its slots, and a parameter tensor of its own
    where it updates a copy rather than the parameter or a view of it
    (each storage counted once)."""
    inner = getattr(opt_state, "inner", opt_state)
    model = getattr(opt_state, "params", None)
    if model is None:
        model = [p for g in inner.param_groups for p in g["params"]]
    params = {p.untyped_storage().data_ptr() for p in model}
    owned = {}
    for t in [v for slots in inner.state.values() for v in slots.values()] + [
            p for g in inner.param_groups for p in g["params"]]:
        if torch.is_tensor(t) and t.untyped_storage().data_ptr() not in params:
            owned[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
    return sum(owned.values())
