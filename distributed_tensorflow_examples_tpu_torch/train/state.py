"""TrainState: the port's unit of trainable state.

The twin of ``distributed_tensorflow_examples_tpu/train/state.py``: one
object holding the step, the parameters, the optimizer state, mutable
non-trainable model state and the run's seed, which the checkpoint saves
and restores as one.  On one device there is nothing to shard, so
:func:`create_state` is the whole of ``create_sharded_state``.

Parameters are separate leaf tensors that require grad: autograd and the
optimizer update each one in place.  A tree of views into one buffer
(``bridge.flat_param_spec``'s ``unflatten``) is copied leaf by leaf first.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..bridge import _leaves


@dataclasses.dataclass
class TrainState:
    step: int  # the global step
    params: Any  # nested dict of f32 leaf tensors (requires_grad)
    opt_state: Any  # the optimizer's ``init(params)``; holds ``params``
    model_state: Any  # mutable non-trainable state (e.g. batchnorm stats)
    seed: int  # per-step randomness source, folded with the step


def leaves(tree) -> list:
    """The tensors of a nested dict in sorted-key order (the ``jax.tree``
    order of ``bridge.flat_param_spec``)."""
    return [leaf for _path, leaf in _leaves(tree)]


def as_param_leaves(tree, device) -> dict:
    """Every leaf of ``tree`` (numpy arrays or tensors) as its own
    contiguous tensor on ``device`` that requires grad — never a view that
    shares storage with another leaf."""
    if isinstance(tree, dict):
        return {k: as_param_leaves(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        leaf = tree.detach().to(device=device, copy=True).contiguous()
    else:
        leaf = torch.tensor(np.asarray(tree), device=device)
    return leaf.requires_grad_(True)


def create_state(init_params_fn: Callable, optimizer, seed: int, device) -> TrainState:
    """``init_params_fn(seed) -> params | (params, model_state)`` (numpy or
    tensor leaves), placed on ``device`` as separate leaves, with the
    optimizer's initial state."""
    out = init_params_fn(seed)
    params, model_state = out if isinstance(out, tuple) else (out, {})
    params = as_param_leaves(params, device)
    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(params),
        model_state=model_state,
        seed=int(seed),
    )
