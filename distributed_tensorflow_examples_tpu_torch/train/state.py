"""TrainState: the port's unit of trainable state.

The twin of ``distributed_tensorflow_examples_tpu/train/state.py``: one
object holding the step, the parameters, the optimizer state, mutable
non-trainable model state and the run's seed, which the checkpoint saves
and restores as one.  Under data parallelism every rank holds the whole
state (the replicated part of ``create_sharded_state``): each draws the
JAX init from the seed, and :func:`check_replicas_equal` proves at
start-up that the ranks hold the same parameters.

Parameters are separate leaf tensors that require grad: autograd and the
optimizer update each one in place.  A tree of views into one buffer
(``bridge.flat_param_spec``'s ``unflatten``) is copied leaf by leaf first.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

import numpy as np
import torch

from ..bridge import _leaves
from ..parallel import collectives


@dataclasses.dataclass
class TrainState:
    step: int  # the global step
    params: Any  # nested dict of f32 leaf tensors (requires_grad)
    opt_state: Any  # the optimizer's ``init(params)``; holds ``params``
    model_state: Any  # mutable non-trainable state (e.g. batchnorm stats)
    seed: int  # the run's key is threefry.key(seed); each step folds in its number


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


def as_state_leaves(tree, device):
    """Every leaf of ``tree`` (numpy arrays or tensors) as a tensor on
    ``device`` that takes no gradient: model state such as BatchNorm's
    running stats, which the checkpoint saves and loads as tensors."""
    if isinstance(tree, dict):
        return {k: as_state_leaves(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device=device, copy=True)
    return torch.tensor(np.asarray(tree), device=device)


def create_state(init_params_fn: Callable, optimizer, seed: int, device) -> TrainState:
    """``init_params_fn(seed) -> params | (params, model_state)`` (numpy or
    tensor leaves), placed on ``device``: params as separate leaves that
    require grad, model state as tensors that do not, with the optimizer's
    initial state."""
    out = init_params_fn(seed)
    params, model_state = out if isinstance(out, tuple) else (out, {})
    params = as_param_leaves(params, device)
    return TrainState(
        step=0,
        params=params,
        opt_state=optimizer.init(params),
        model_state=as_state_leaves(model_state, device),
        seed=int(seed),
    )


def params_sha256(params) -> str:
    """sha256 of the parameters' float32 bytes in ``leaves`` order."""
    h = hashlib.sha256()
    for leaf in leaves(params):
        h.update(leaf.detach().to("cpu", torch.float32).contiguous().numpy().tobytes())
    return h.hexdigest()


def check_replicas_equal(params) -> str:
    """Raise unless every rank of the data axis holds bit-for-bit the same
    parameters (one all-gather of a checksum); returns the checksum."""
    digest = params_sha256(params)
    digests = collectives.all_gather_object(digest)
    if len(set(digests)) != 1:
        raise RuntimeError(
            f"the data-parallel replicas hold different parameters: sha256 by rank {digests}"
        )
    return digest
