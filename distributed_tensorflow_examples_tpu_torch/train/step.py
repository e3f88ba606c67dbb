"""Train and eval steps: the port of
``distributed_tensorflow_examples_tpu/train/step.py`` on one device.

One call of ``step(state, batch) -> (state, metrics)`` is forward,
backward and optimizer update.  PyTorch runs eagerly, so nothing is
compiled; the step consumes its input state (parameters and moments are
updated in place, the analog of the JAX step's donated buffers) and
returns the next one.

- ``grad_accum=k``: the batch splits into k microbatches along dim 0;
  their gradients are summed (autograd accumulates into ``.grad``) and
  divided by k, and ONE optimizer update follows — the numerics of the
  full batch for a global-mean loss.  Metrics are the microbatches' mean.
- ``unroll=k``: k steps per call over a [k, ...] super-batch; only the
  last step's metrics are reported.

``loss_fn(params, model_state, batch, rng) -> (loss, (model_state,
metrics))`` as in the JAX package; ``rng`` is ``(seed, step)`` (and
``(seed, step, microbatch)`` under accumulation), the per-step
randomness source a loss that draws noise folds into a
``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .state import TrainState, leaves


def _zero_grads(params) -> None:
    for p in leaves(params):
        p.grad = None


def build_train_step(
    loss_fn: Callable, optimizer, *, unroll: int = 1, grad_accum: int = 1
):
    """Returns ``step(state, batch) -> (state, metrics)``."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")

    def one_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state.params
        _zero_grads(params)
        if grad_accum == 1:
            loss, (model_state, metrics) = loss_fn(
                params, state.model_state, batch, (state.seed, state.step)
            )
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
                loss, (model_state, m) = loss_fn(
                    params, model_state, mb, (state.seed, state.step, i)
                )
                loss.backward()
                per_micro.append(m)
            for p in leaves(params):
                if p.grad is not None:
                    p.grad.div_(grad_accum)
            metrics = {
                k: torch.stack([m[k] for m in per_micro]).mean(dim=0)
                for k in per_micro[0]
            }
        optimizer.update(state.opt_state, params)
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
