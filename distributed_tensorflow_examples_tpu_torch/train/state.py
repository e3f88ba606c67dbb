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
from ..parallel import collectives, sharding
from ..parallel.partitioner import min_max_variable_partitioner


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


def create_sharded_state(
    init_params_fn: Callable,
    optimizer,
    seed: int,
    device,
    *,
    mesh,
    rules: sharding.ShardingRules = (),
    auto_shard_min_bytes: int | None = None,
    zero_opt_sharding: bool = False,
    zero_min_elements: int = 65536,
) -> tuple[TrainState, dict]:
    """The state of :func:`create_state` laid out over ``mesh`` by the rule
    table: each rank keeps its block of every leaf a rule shards (the
    global leaf drawn on the host, then sliced).

    ``auto_shard_min_bytes``: a leaf no rule matches whose per-model-shard
    slice would still hold at least this many bytes gets its leading dim
    sharded over ``model`` (``min_max_variable_partitioner``); explicit
    rules win.  ``zero_opt_sharding`` (ZeRO-1, JAX ``_zero_shard_opt``):
    the slots of every leaf of at least ``zero_min_elements`` that no rule
    shards are sharded along the first dim the data degree divides (each
    rank holds its 1/D of their elements as one contiguous chunk:
    ``optim.ShardedOptState``).

    Returns ``(state, specs)``: ``specs["params"]`` the tree of each
    leaf's spec, ``specs["opt_state"]`` of its slots' global layout, JAX's
    (one per leaf; the ZeRO-1 ones over ``data``)."""
    if zero_opt_sharding and mesh.shape.get("expert", 1) > 1:
        raise NotImplementedError(
            "--zero_opt on an 'expert' mesh axis waits for the port's item A8b-2b")
    out = init_params_fn(seed)
    params, model_state = out if isinstance(out, tuple) else (out, {})
    default_fn = None
    if auto_shard_min_bytes is not None and mesh.shape.get("model", 1) > 1:
        decide = min_max_variable_partitioner(auto_shard_min_bytes)

        def default_fn(path, leaf):
            return decide(tuple(leaf.shape), leaf.dtype.itemsize, mesh.shape["model"])

    param_specs = sharding.sharding_tree(params, mesh, rules, default_spec_fn=default_fn)
    local = _map2(lambda leaf, spec: sharding.block(leaf, spec, mesh),
                  params, param_specs)
    data = mesh.shape.get("data", 1)
    opt_specs = _map2(
        lambda leaf, spec: _zero_spec(np.shape(leaf), spec, data, zero_min_elements)
        if zero_opt_sharding else spec, params, param_specs)
    params = as_param_leaves(local, device)
    sharded_model = mesh.shape.get("model", 1) > 1
    sharded_expert = mesh.shape.get("expert", 1) > 1
    plan = [_leaf_plan(ps, os_, sharded_model, sharded_expert)
            for ps, os_ in zip(leaves(param_specs), leaves(opt_specs))]
    if any(lp.axes or lp.zero for lp in plan):
        from .optim import ShardedOptState

        opt_state = ShardedOptState(optimizer, params, plan, data_group=mesh.group,
                                    model_group=mesh.model_group,
                                    expert_group=getattr(mesh, "expert_group", None))
    else:
        opt_state = optimizer.init(params)
    state = TrainState(step=0, params=params, opt_state=opt_state,
                       model_state=as_state_leaves(model_state, device), seed=int(seed))
    return state, {"params": param_specs, "opt_state": opt_specs}


def _map2(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def _zero_spec(shape, spec, data: int, min_elements: int):
    """JAX ``_zero_shard_opt`` for one slot: the first dim ``data``
    divides, over ``data``, when the leaf is big enough and no rule
    shards it; else ``spec``."""
    if data <= 1 or not shape or int(np.prod(shape)) < min_elements:
        return spec
    if any(e is not None for e in spec):
        return spec
    for d, s in enumerate(shape):
        if s % data == 0:
            entries = [None] * len(shape)
            entries[d] = "data"
            return sharding.P(*entries)
    return spec


def _leaf_plan(param_spec, opt_spec, sharded_model: bool, sharded_expert: bool = False):
    from .optim import LeafPlan

    model_dim = sharding.sharded_dim(param_spec, "model") if sharded_model else None
    expert_dim = sharding.sharded_dim(param_spec, "expert") if sharded_expert else None
    return LeafPlan(model_dim=model_dim, zero=opt_spec != param_spec, expert_dim=expert_dim)


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
