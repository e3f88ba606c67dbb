"""Functional layers over plain dicts of tensors.

The port of the pieces of ``distributed_tensorflow_examples_tpu/
models/layers.py`` the transformer needs: its forward's dense and
embedding layers and its training loss.  Kernels keep the JAX
[in, out] layout (``x @ W``), so a parameter tree crosses between the two
packages without a transpose.
"""

from __future__ import annotations

import torch


def dense(params, x, *, dtype=None):
    """``x @ kernel + bias``.  With ``dtype``, both operands and the bias
    are cast to it first and the product comes out in it (the JAX compute-
    dtype matmul); without, the product runs in float32."""
    k = params["kernel"]
    if dtype is None:
        dtype = torch.float32
    y = torch.matmul(x.to(dtype), k.to(dtype))
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


def embedding_lookup(params, ids, *, dtype=None):
    """Gather rows of ``params["table"]`` as ``jnp.take`` does: a negative
    id counts from the end, and an id outside [-V, V) gives a row of NaN
    (JAX's fill mode) instead of a device-side fault."""
    t = params["table"]
    n = t.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    rows = t[ids.clamp(0, n - 1)]
    rows = torch.where(valid[..., None], rows, torch.nan)
    return rows if dtype is None else rows.to(dtype)


def softmax_cross_entropy(logits, labels):
    """Mean cross-entropy: f32 logsumexp minus the gold logit, averaged
    over every row (the JAX ``layers.softmax_cross_entropy``)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()
