"""Train and eval steps: the port of
``distributed_tensorflow_examples_tpu/train/step.py``.

One call of ``step(state, batch) -> (state, metrics)`` is forward,
backward and optimizer update.  PyTorch runs eagerly, so nothing is
compiled; the step consumes its input state (parameters and moments are
updated in place, the analog of the JAX step's donated buffers) and
returns the next one.

Data parallelism (a ``mesh`` whose data group is up,
``parallel/mesh.py``): the step runs under the mesh's group (no mesh, or
a mesh without a group: one rank), so plain BN and the LSTM's dropout
rows read the group the gradients are summed over.  Each rank takes the
gradient of its local mean loss over its rows of the global batch;
:func:`sync_gradients`
mean-all-reduces the gradients in one flat float32 bucket; only then
does the optimizer run, so a global-norm clip sees the global gradient,
as in the JAX step whose loss is the global-batch mean.  The metrics are
averaged over the ranks: the global batch's.

- ``grad_accum=k``: the batch splits into k microbatches along dim 0;
  their gradients are summed (autograd accumulates into ``.grad``) and
  divided by k, and ONE optimizer update follows — the numerics of the
  full batch for a global-mean loss.  Metrics are the microbatches' mean.
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


def sync_gradients(params, group) -> None:
    """Replace every leaf's ``.grad`` (zeros where autograd left none) by
    its mean over the ranks of ``group``: one all-reduce of one flat
    float32 bucket."""
    ps = leaves(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads])
    with collectives.use_group(group):
        collectives.all_reduce_sum_(flat, tag="grads")
    flat.div_(group.size)
    offset = 0
    for p in ps:
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
    ``mesh`` with a data group, the step is data parallel (module
    docstring)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    group = mesh.group if mesh is not None else None
    if group is not None and group.size > 1 and grad_accum > 1:
        raise NotImplementedError(
            f"grad_accum={grad_accum} under data parallelism over {group.size} ranks: "
            "the JAX step splits the GLOBAL batch into microbatches, so a "
            "microbatch spans other ranks' rows; open fault C6 (ROADMAP.md)"
        )

    def one_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        with collectives.use_group(group):
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
            sync_gradients(params, group)
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
