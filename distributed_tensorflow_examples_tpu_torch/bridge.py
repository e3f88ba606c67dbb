"""Weights across the two packages.

- :func:`flat_param_spec` is the flat-vector convention of the JAX
  package's ``parallel/ps_shard.flat_param_spec`` and
  ``train/checkpoint.flat_params_of``: leaves in ``jax.tree`` order,
  row-major, concatenated as float32.  ``jax.tree`` walks a dict in SORTED
  key order — ``block_0, block_1, block_10, block_11, block_2, ...`` and,
  inside a block, ``ln1, ln2, mlp_in, mlp_out, proj, qkv`` — so a walk in
  insertion order would decode a published vector into the wrong tree
  with no error.  This module is the port's one spelling of that order.
- :func:`params_from_numpy` turns a JAX param tree held as numpy arrays
  into the port's tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def _items(tree, prefix=()):
    """``(key path tuple, leaf)`` pairs in ``jax.tree`` order (dict keys
    sorted), for any dict keys — a ResNet's ``"stage0/block0"`` included."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _leaves(tree):
    """``(path, leaf)`` pairs in ``jax.tree`` order, the path's keys joined
    by ``/`` (a name for messages and checkpoint files, not for rebuilding
    the tree: a key may hold a ``/`` itself)."""
    for path, leaf in _items(tree):
        yield "/".join(path), leaf


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def flat_param_spec(template):
    """``(total_elems, unflatten)`` for a param tree ``template`` whose
    leaves are shape tuples (``models.transformer.param_shapes``), arrays
    or tensors.  ``unflatten(flat, device)`` copies the float32 vector to
    ``device`` once and returns the tree as views into that one buffer
    (no copy when ``flat`` is a float32 tensor on ``device`` already: the
    views then share its storage)."""
    paths, shapes = zip(*[(p, _shape(l)) for p, l in _items(template)])
    sizes = [int(np.prod(s)) if s else 1 for s in shapes]
    offsets = np.cumsum([0] + sizes).tolist()
    total = offsets[-1]

    def unflatten(flat, device="cpu"):
        if isinstance(flat, torch.Tensor):
            flat = flat.reshape(-1).to(torch.float32)
        else:
            flat = torch.as_tensor(np.asarray(flat, np.float32).reshape(-1))
        if flat.numel() != total:
            raise ValueError(
                f"flat vector has {flat.numel()} elements, the tree needs {total}"
            )
        flat = flat.to(device)
        tree: dict = {}
        for path, shape, a, b in zip(paths, shapes, offsets, offsets[1:]):
            *parents, leaf = path
            node = tree
            for key in parents:
                node = node.setdefault(key, {})
            node[leaf] = flat[a:b].view(shape)
        return tree

    return total, unflatten


def flat_params_of(tree) -> np.ndarray:
    """The float32 flat vector of a param tree (numpy arrays or tensors) in
    registry order — what ``ModelRegistry.publish`` stores."""
    leaves = [l for _p, l in _leaves(tree)]
    if not leaves:
        raise ValueError("no parameter leaves to flatten")
    return np.concatenate([
        (l.detach().cpu().numpy() if isinstance(l, torch.Tensor) else np.asarray(l))
        .astype(np.float32, copy=False).reshape(-1)
        for l in leaves
    ])


def params_from_numpy(tree, device="cpu") -> dict:
    """A JAX param tree held as numpy arrays -> the same tree of tensors on
    ``device`` (values and dtypes unchanged)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)
