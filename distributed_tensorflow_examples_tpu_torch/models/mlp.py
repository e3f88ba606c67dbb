"""MNIST MLP (W1), forward and training loss: the port of
``distributed_tensorflow_examples_tpu/models/mlp.py``.

Dense layers with ReLU between them, each in the compute dtype (bf16 by
default) through ``layers.dense``; the parameter tree is the JAX one
(``dense_<i>``: kernel [in, out], bias), so trees and flat vectors move
between the packages as they are.  No BatchNorm and no kernel of the
port's own: the products are ``torch.matmul``, as the JAX package's are
XLA's dot.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import device as device_lib
from ..utils import threefry
from . import layers


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``: the same fields and defaults."""

    input_dim: int = 784
    hidden: tuple[int, ...] = (128, 128)
    num_classes: int = 10
    compute_dtype: str = "bfloat16"

    @property
    def dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.compute_dtype)


def init_numpy(cfg: Config, seed: int, *, device=None):
    """The JAX ``init(cfg, jax.random.key(seed))`` as a tree of float32
    numpy arrays: layer i from ``split(key(seed), layers)[i]``,
    glorot-uniform kernels (bit for bit) and zero biases."""
    dev = device_lib.for_drawing(device)
    dims = (cfg.input_dim, *cfg.hidden, cfg.num_classes)
    rngs = threefry.split(threefry.key(seed), len(dims) - 1)
    return layers.as_numpy({
        f"dense_{i}": layers.dense_init(rngs[i], din, dout, device=dev)
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:]))
    })


def apply(cfg: Config, params, x):
    """x: [B, 28, 28, 1] or [B, input_dim] -> logits [B, num_classes] in
    the compute dtype."""
    x = x.reshape(x.shape[0], -1)
    n = len(cfg.hidden) + 1
    for i in range(n):
        x = layers.dense(params[f"dense_{i}"], x, dtype=cfg.dtype)
        if i < n - 1:
            x = torch.relu(x)
    return x


def loss_fn(cfg: Config):
    """``f(params, model_state, batch, rng) -> (loss, (model_state,
    metrics))``: softmax cross-entropy, metrics ``loss`` and ``accuracy``."""

    def f(params, model_state, batch, rng):
        del rng  # the MLP draws no noise
        logits = apply(cfg, params, batch["image"])
        loss = layers.softmax_cross_entropy(logits, batch["label"])
        acc = layers.accuracy(logits, batch["label"])
        return loss, (model_state, {"loss": loss.detach(), "accuracy": acc})

    return f
