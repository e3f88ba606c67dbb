"""Pipeline parallelism over the ``pipe`` mesh axis (the GPipe schedule):
the port of ``distributed_tensorflow_examples_tpu/parallel/pipeline.py``.

The layer stack is stacked: per-layer trees become one tree whose leaves
carry a leading layer dim (:func:`stack_stages`), laid out ``P("pipe")``
by :func:`stage_sharding_rules`, so each pipe rank holds its L/S
consecutive layers.  :func:`pipeline_apply` runs the JAX schedule: the
batch splits into M microbatches and every rank runs M + S - 1 ticks; at
each tick rank 0 takes a fresh microbatch (the trailing ticks take the
last one again), every other rank the activation its predecessor sent
last tick, each runs its stage and sends its output one hop around the
pipe ring (``collectives.ring_permute``, counted under
``TRAFFIC["pipe"]``).  Bubble ticks compute and send, and their
results are discarded.  The valid outputs are the last rank's at ticks
S - 1 ... S + M - 2, broadcast to every pipe rank by a masked sum
(``TRAFFIC["pipe_out"]``).  The last tick's handoff, whose buffer JAX's
scan carries out and drops, is not sent.

The backward is autograd's walk of the same ticks in reverse: each
handoff's backward sends the cotangent one hop back, one at a time and
in the same order on every rank (every rank's graph is the same chain:
rank 0 selects its input with ``torch.where`` as JAX does, so the
handoff it ignores still takes its zero cotangent).  The boundary is
float32 on both sides, as JAX casts it: the input, replicated over pipe
and read by rank 0 alone, takes its cotangent summed over the axis (JAX's
transpose of a ``P()`` ``shard_map`` input; ``TRAFFIC["pipe_in"]``), so
every pipe rank holds the sequential model's gradient of what precedes
the stack; the output's cotangent passes through, since what follows is
replicated over pipe.  ``remat`` recomputes only the stage body in the
backward (``torch.utils.checkpoint``, non-reentrant, run under the
mesh's axes: a recomputation runs on autograd's thread), never a
handoff.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from . import collectives
from .mesh import AXIS_PIPE
from .partitioner import PartitionSpec as P


def tree_map(fn, *trees):
    """``fn`` over the leaves of dict trees of one structure, leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stack_stages(per_stage: list[Any]) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage dim
    (numpy leaves stack as numpy, tensors as tensors)."""
    def stack(*xs):
        return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)

    return tree_map(stack, *per_stage)


def unstack_stages(stacked: Any, n: int) -> list[Any]:
    """The ``n`` per-layer trees of a stacked tree."""
    return [tree_map(lambda x: x[i], stacked) for i in range(n)]


def _under_axes(mesh, fn):
    def run(*args):
        with mesh.axes():
            return fn(*args)

    return run


def pipeline_apply(mesh, stage_fn: Callable, stacked_params, h: torch.Tensor, *,
                   microbatches: int, axis: str = AXIS_PIPE, remat: bool = True):
    """Run ``h`` [B, ...] through the S pipeline stages of ``mesh``'s
    ``axis`` (module docstring); returns the last stage's activations,
    the same on every pipe rank, in ``h``'s dtype.

    ``stacked_params``: this rank's layers, leading dim L/S;
    ``stage_fn(rank_params, x) -> x`` is one stage's forward over them.
    Differentiable.  Without a pipe axis (S = 1) the whole stack is one
    stage, applied directly.  Run under the mesh's axes (a train step's)."""
    S = 1 if mesh is None else mesh.shape.get(axis, 1)
    if S == 1:
        return stage_fn(stacked_params, h)
    M = microbatches
    B = h.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches={M}")
    body = stage_fn
    if remat and torch.is_grad_enabled():
        inner = _under_axes(mesh, stage_fn)

        def body(p, x):
            return checkpoint(inner, p, x, use_reentrant=False)

    r = collectives.axis_index(axis)
    dtype = h.dtype
    h_mb = collectives.copy_to_axis(h.reshape(M, B // M, *h.shape[1:]).to(torch.float32),
                                    axis, tag="pipe_in")
    first = torch.tensor(r == 0, device=h.device)
    buf = torch.zeros(h_mb.shape[1:], dtype=dtype, device=h.device)
    outs = []
    n_ticks = M + S - 1
    for t in range(n_ticks):
        x = torch.where(first, h_mb[min(t, M - 1)].to(dtype), buf)
        out = body(stacked_params, x)
        outs.append(out)
        if t < n_ticks - 1:
            buf = collectives.ring_permute(out, axis, shift=1, tag="pipe")
    valid = torch.stack(outs[S - 1:S - 1 + M]).to(torch.float32)
    mask = 1.0 if r == S - 1 else 0.0
    out_mb = collectives.reduce_from_axis(valid * mask, axis, tag="pipe_out")
    return out_mb.reshape(B, *h.shape[1:]).to(dtype)


def stage_sharding_rules(inner_rules: tuple, prefix: str, axis: str = AXIS_PIPE) -> tuple:
    """Lift a per-layer rule table onto stacked params: every leaf gains a
    leading stage dim sharded over ``axis``; inner specs shift right.

    ``(r"qkv/kernel", P(None, "model"))`` ->
    ``(rf"{prefix}/qkv/kernel", P("pipe", None, "model"))``."""
    out = [(f"{prefix}/{pat}", P(axis, *spec)) for pat, spec in inner_rules]
    # Default: any stacked leaf not matched above still shards its stage dim.
    out.append((f"{prefix}/.*", P(axis)))
    return tuple(out)
