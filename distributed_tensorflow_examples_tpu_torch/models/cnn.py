"""CIFAR-10 CNN (W2), forward and training loss: the port of
``distributed_tensorflow_examples_tpu/models/cnn.py``.

Two blocks of 5x5 conv, ReLU and 2x2 max pool, then two ReLU dense
layers and the logits, all in the compute dtype (bf16 by default).
Activations are NHWC and conv kernels HWIO, as in JAX; each conv is
``layers.conv2d`` (cuDNN over the channels_last NCHW view of the NHWC
tensor) and the pool is ``F.max_pool2d`` over the same view, the twin of
``lax.reduce_window(max)`` with window and stride 2, VALID.  The parameter
tree is the JAX one (``conv_<i>``, ``dense_<j>``, ``logits``).  No kernel
of the port's own: the JAX package computes this model with XLA's conv
and dot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import device as device_lib
from ..utils import threefry
from . import layers


@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``: the same fields and defaults."""

    num_classes: int = 10
    channels: tuple[int, ...] = (64, 64)
    dense: tuple[int, ...] = (384, 192)
    compute_dtype: str = "bfloat16"

    @property
    def dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.compute_dtype)


def init_numpy(cfg: Config, seed: int, *, image_size: int = 32, in_channels: int = 3,
               device=None):
    """The JAX ``init(cfg, jax.random.key(seed))`` as a tree of float32
    numpy arrays, from ``split(key(seed), convs + denses + 1)``: He-normal
    conv kernels from their keys as they are, He-normal hidden dense
    kernels (``init="he"``), and the logits kernel ``(1 / din) *
    normal(split(last key)[0])``, the TF tutorial's small softmax scale
    (normal leaves within a few float32 ulps of JAX's); zero biases."""
    dev = device_lib.for_drawing(device)
    n_conv, n_dense = len(cfg.channels), len(cfg.dense)
    rngs = threefry.split(threefry.key(seed), n_conv + n_dense + 1)
    params = {}
    cin = in_channels
    for i, cout in enumerate(cfg.channels):
        params[f"conv_{i}"] = layers.conv_init(rngs[i], 5, 5, cin, cout, device=dev)
        cin = cout
    din = (image_size // (2 ** n_conv)) ** 2 * cin
    for j, dout in enumerate(cfg.dense):
        params[f"dense_{j}"] = layers.dense_init(rngs[n_conv + j], din, dout, init="he",
                                                 device=dev)
        din = dout
    # The JAX init draws a glorot kernel here and overwrites it with this.
    kr, _ = threefry.split(rngs[-1])
    scale = torch.tensor(np.float32(1.0 / din), device=dev)
    params["logits"] = {
        "kernel": scale * threefry.normal(kr, (din, cfg.num_classes), dev),
        "bias": np.zeros((cfg.num_classes,), np.float32),
    }
    return layers.as_numpy(params)


def apply(cfg: Config, params, x):
    """x: [B, H, W, C] float -> logits [B, num_classes] in the compute
    dtype."""
    for i in range(len(cfg.channels)):
        x = torch.relu(layers.conv2d(params[f"conv_{i}"], x, dtype=cfg.dtype))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    x = x.reshape(x.shape[0], -1)
    for j in range(len(cfg.dense)):
        x = torch.relu(layers.dense(params[f"dense_{j}"], x, dtype=cfg.dtype))
    return layers.dense(params["logits"], x, dtype=cfg.dtype)


def loss_fn(cfg: Config):
    """``f(params, model_state, batch, rng) -> (loss, (model_state,
    metrics))``: softmax cross-entropy, metrics ``loss`` and ``accuracy``."""

    def f(params, model_state, batch, rng):
        del rng  # the CNN draws no noise
        logits = apply(cfg, params, batch["image"])
        loss = layers.softmax_cross_entropy(logits, batch["label"])
        acc = layers.accuracy(logits, batch["label"])
        return loss, (model_state, {"loss": loss.detach(), "accuracy": acc})

    return f
