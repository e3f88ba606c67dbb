"""Train and eval steps: the port of
``distributed_tensorflow_examples_tpu/train/step.py``.

One call of ``step(state, batch) -> (state, metrics)`` is forward,
backward and optimizer update.  PyTorch runs eagerly, so nothing is
compiled; the step consumes its input state (parameters and moments are
updated in place, the analog of the JAX step's donated buffers) and
returns the next one.

Data, expert and sequence parallelism (a ``mesh`` whose groups are up,
``parallel/mesh.py``): the step runs under the mesh's groups (no mesh, or
a mesh without a group: one rank), so plain BN and the LSTM's dropout
rows read the data group, the vocab-parallel and Megatron layers the
mesh's ``model`` group, the sequence-parallel attention its ``seq``
group and the experts its ``expert`` group.  The gradients are averaged
over the ``data`` x ``expert`` x ``seq`` ranks (``Mesh.batch_group``):
each of them holds its own tokens of the global batch (rows over data x
expert, a slice of the sequence over ``seq``), and takes the gradient of
its local token mean, the cross-shard terms of attention and of the
experts arriving through the ring's or the all-to-alls' backward.  An
expert leaf is different: this rank holds its block of the experts, and
its gradient already sums the tokens the all-to-all brought from every
rank of its expert group, so it is summed over the data x seq ranks
alone (``Mesh.expert_grad_group``) and divided by the whole batch
group's size (a mean over the data ranks alone would be X times too
large).  The model ranks of one data, expert and seq index hold
replicated leaves whose gradients are equal already (the loss is
replicated over ``model``), and their own blocks of the sharded ones.
:func:`sync_gradients` mean-all-reduces the gradients in flat float32
buckets; only then does the optimizer run, so a global-norm clip sees
the global gradient, as in the JAX step whose loss is the global-batch
mean.  The metrics are averaged over the same ranks: the global
batch's.

- ``grad_accum=k``: the batch splits into k microbatches along dim 0;
  their gradients are summed (autograd accumulates into ``.grad``) and
  divided by k, and ONE optimizer update follows — the numerics of the
  full batch for a global-mean loss.  Metrics are the microbatches' mean.
  Under data parallelism the JAX step cuts the GLOBAL batch into k
  microbatches, so each rank's local batch holds its share of each, in
  microbatch order (``data/pipeline.py``, ``sharding.microbatch_rows``):
  chunk i is this rank's rows of global microbatch i, its BatchNorm
  statistics summed over the ranks, under the same per-microbatch key on
  every rank.
- ``unroll=k``: k steps per call over a [k, ...] super-batch; only the
  last step's metrics are reported.

``loss_fn(params, model_state, batch, rng) -> (loss, (model_state,
metrics))`` as in the JAX package, and ``rng`` the JAX step's key
(``utils/threefry.py``, two uint32 words): ``fold_in(key(seed), step)``
for the step, as the JAX step's ``fold_in(state.rng, state.step)``;
under accumulation the JAX chain, ``rng, sub = split(rng)`` per
microbatch with ``sub`` handed to the loss; under unroll each sub-step
folds in its own step number.  A loss that draws noise (word2vec's
negatives, the LSTM's dropout) draws it from this key with
``threefry``, so it gets the JAX package's numbers.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..parallel import collectives
from ..utils import threefry
from .state import TrainState, leaves


def _zero_grads(params) -> None:
    for p in leaves(params):
        p.grad = None


def sync_gradients(params, group, expert_sharded=None, expert_group=None) -> None:
    """Replace every leaf's ``.grad`` (zeros where autograd left none) by
    its mean over the ranks of ``group``: one all-reduce of one flat
    float32 bucket.  The leaves ``expert_sharded`` marks are summed over
    ``expert_group`` (None: this rank alone) in a second bucket and
    divided by ``group``'s size too."""
    ps = leaves(params)
    marks = expert_sharded or [False] * len(ps)
    for experts, sum_group in ((False, group), (True, expert_group)):
        mine = [p for p, m in zip(ps, marks) if m == experts]
        if not mine:
            continue
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in mine]
        flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
        with collectives.use_group(sum_group), collectives.bucket([g.shape for g in grads]):
            collectives.all_reduce_sum_(flat, tag="expert_grads" if experts else "grads")
        flat.div_(group.size)
        offset = 0
        for p in mine:
            n = p.numel()
            p.grad = flat[offset : offset + n].view_as(p).to(p.dtype)
            offset += n


def mean_metrics(metrics: dict, group) -> dict:
    """The metrics averaged over the ranks of ``group`` (one all-reduce)."""
    keys = sorted(metrics)
    vec = torch.stack([metrics[k].detach().to(torch.float32).reshape(()) for k in keys])
    with collectives.use_group(group):
        collectives.all_reduce_sum_(vec, tag="metrics")
    vec.div_(group.size)
    return {k: vec[i] for i, k in enumerate(keys)}


def build_train_step(
    loss_fn: Callable, optimizer, *, mesh=None, unroll: int = 1, grad_accum: int = 1
):
    """Returns ``step(state, batch) -> (state, metrics)``.  Over a
    ``mesh`` with a data or seq group, the gradients are averaged over its
    ``batch_group`` (module docstring)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    group = mesh.batch_group if mesh is not None else None
    expert_group = getattr(mesh, "expert_grad_group", None)
    axes = mesh.axes if mesh is not None else (lambda: collectives.use_group(None))

    def one_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        with axes():
            return _one_step(state, batch)

    def _one_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state.params
        _zero_grads(params)
        rng = threefry.fold_in(threefry.key(state.seed), state.step)
        if grad_accum == 1:
            loss, (model_state, metrics) = loss_fn(params, state.model_state, batch, rng)
            loss.backward()
        else:
            for key, x in batch.items():
                if x.shape[0] % grad_accum:
                    raise ValueError(
                        f"batch field {key!r} dim {x.shape[0]} not divisible by "
                        f"grad_accum={grad_accum}"
                    )
            micro = {k: x.chunk(grad_accum, dim=0) for k, x in batch.items()}
            model_state, per_micro = state.model_state, []
            for i in range(grad_accum):
                mb = {k: parts[i] for k, parts in micro.items()}
                rng, sub = threefry.split(rng)
                loss, (model_state, m) = loss_fn(params, model_state, mb, sub)
                loss.backward()
                per_micro.append(m)
            for p in leaves(params):
                if p.grad is not None:
                    p.grad.div_(grad_accum)
            metrics = {
                k: torch.stack([m[k] for m in per_micro]).mean(dim=0)
                for k in per_micro[0]
            }
        if group is not None:
            sync_gradients(params, group, getattr(state.opt_state, "expert_sharded", None),
                           expert_group)
            metrics = mean_metrics(metrics, group)
        optimizer.update(state.opt_state, params, state.step)
        _zero_grads(params)
        return (
            TrainState(
                step=state.step + 1, params=params, opt_state=state.opt_state,
                model_state=model_state, seed=state.seed,
            ),
            metrics,
        )

    if unroll == 1:
        return one_step

    def stepper(state: TrainState, super_batch):
        metrics = {}
        for i in range(unroll):
            state, metrics = one_step(state, {k: x[i] for k, x in super_batch.items()})
        return state, metrics  # only the last sub-step's metrics

    return stepper


def build_eval_step(eval_fn: Callable):
    """``eval(state, batch) -> metrics``, with autograd off."""

    def stepper(state: TrainState, batch):
        with torch.no_grad():
            return eval_fn(state.params, state.model_state, batch)

    return stepper
