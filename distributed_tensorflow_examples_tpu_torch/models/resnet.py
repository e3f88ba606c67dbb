"""ResNet-50 (v1.5), forward and training loss: the port of
``distributed_tensorflow_examples_tpu/models/resnet.py`` (the reference's
W3 MirroredStrategy workload).

NHWC activations and HWIO conv kernels, as in JAX; each conv runs in the
compute dtype (bf16 by default) through ``layers.conv2d``, which reads the
NHWC tensor as channels_last NCHW for cuDNN, so every activation on the
path stays [M, C] row-major — the layout the BN statistics kernels read.
The parameter and state trees are the JAX ones (``stem``, ``bn_stem``,
``stage<s>/block<b>``, ``head``), so trees and flat registry vectors move
between the packages as they are.

``mesh`` (a ``parallel.mesh.Mesh``) sends every BatchNorm through the
fused statistics path, the B6/B7 kernels on the card (``ops/bn.py``;
SyncBN when its row shards are more than one rank), as the JAX ``mesh=``
does; without it BatchNorm is plain torch.  Ghost-batch BN
(``bn_ghost_slices`` S > 0, JAX ``_batchnorm_ghost``) takes every
BatchNorm's statistics slice by slice: on a mesh whose ``slice`` axis is
S, over the slice-local data group only (no statistics reduction
crosses a slice; only the gradient all-reduce does), each rank holding
its slice's row of the [S, C] running stats (:func:`sharding_rules`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..utils import device as device_lib
from ..utils import threefry
from . import layers

@dataclasses.dataclass(frozen=True)
class Config:
    """The JAX ``Config``: the same fields and defaults."""

    num_classes: int = 1000
    stage_sizes: tuple[int, ...] = (3, 4, 6, 3)  # ResNet-50
    width: int = 64
    compute_dtype: str = "bfloat16"
    bn_momentum: float = 0.9
    #: "s2d": the 7x7/s2 stem as its exactly equivalent space-to-depth
    #: 4x4/s1 conv (see :func:`_stem_conv`); "conv7": the literal stem.
    stem: str = "s2d"
    bn_ghost_slices: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.compute_dtype)


def _bottleneck_init(key, cin: int, mid: int, *, downsample: bool, ghost: int = 0,
                     device="cpu"):
    """One bottleneck: 1x1 reduce -> 3x3 -> 1x1 expand (+ projection),
    each conv from its own of ``split(key, 4)``."""
    cout = 4 * mid
    ks = threefry.split(key, 4)
    p, s = {}, {}
    p["conv1"] = layers.conv_init(ks[0], 1, 1, cin, mid, use_bias=False, device=device)
    p["bn1"], s["bn1"] = layers.batchnorm_init(mid, ghost_slices=ghost)
    p["conv2"] = layers.conv_init(ks[1], 3, 3, mid, mid, use_bias=False, device=device)
    p["bn2"], s["bn2"] = layers.batchnorm_init(mid, ghost_slices=ghost)
    p["conv3"] = layers.conv_init(ks[2], 1, 1, mid, cout, use_bias=False, device=device)
    p["bn3"], s["bn3"] = layers.batchnorm_init(cout, ghost_slices=ghost)
    if downsample or cin != cout:
        p["proj"] = layers.conv_init(ks[3], 1, 1, cin, cout, use_bias=False, device=device)
        p["bn_proj"], s["bn_proj"] = layers.batchnorm_init(cout, ghost_slices=ghost)
    return p, s


def init_numpy(cfg: Config, seed: int, *, in_channels: int = 3, device=None):
    """The JAX ``init(cfg, jax.random.key(seed))`` as ``(params,
    model_state)`` trees of float32 numpy arrays: the same keys
    (``split(key(seed), 2 + blocks)``: the stem, one per bottleneck, the
    head) and initialisers (He-normal convs within a few float32 ulps of
    JAX's, the glorot-uniform head bit for bit, unit BN scales, zero
    biases, running mean 0 and var 1).  Drawn on ``device``
    (``utils.device.for_drawing``: the card when there is one)."""
    dev = device_lib.for_drawing(device)
    rngs = threefry.split(threefry.key(seed), 2 + sum(cfg.stage_sizes))
    params: dict = {}
    state: dict = {}
    params["stem"] = layers.conv_init(
        rngs[0], 7, 7, in_channels, cfg.width, use_bias=False, device=dev
    )
    params["bn_stem"], state["bn_stem"] = layers.batchnorm_init(
        cfg.width, ghost_slices=cfg.bn_ghost_slices
    )
    cin = cfg.width
    k = 1
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        mid = cfg.width * (2 ** stage)
        for block in range(n_blocks):
            down = stage > 0 and block == 0
            name = f"stage{stage}/block{block}"
            params[name], state[name] = _bottleneck_init(
                rngs[k], cin, mid, downsample=down or cin != 4 * mid,
                ghost=cfg.bn_ghost_slices, device=dev,
            )
            cin = 4 * mid
            k += 1
    params["head"] = layers.dense_init(rngs[-1], cin, cfg.num_classes, device=dev)
    return layers.as_numpy(params), layers.as_numpy(state)


def _bottleneck_apply(cfg: Config, p, s, x, *, stride: int, train: bool, mesh=None):
    new_s = {}
    shortcut = x

    def bn(name, t, relu=False):
        return layers.batchnorm(
            p[name], s[name], t, train=train, momentum=cfg.bn_momentum, mesh=mesh,
            relu=relu, ghost_slices=cfg.bn_ghost_slices,
        )

    y = layers.conv2d(p["conv1"], x, stride=1, dtype=cfg.dtype)
    y, new_s["bn1"] = bn("bn1", y, relu=True)
    # v1.5: the stride lives on the 3x3, not the 1x1.
    y = layers.conv2d(p["conv2"], y, stride=stride, dtype=cfg.dtype)
    y, new_s["bn2"] = bn("bn2", y, relu=True)
    y = layers.conv2d(p["conv3"], y, stride=1, dtype=cfg.dtype)
    y, new_s["bn3"] = bn("bn3", y)
    if "proj" in p:
        shortcut = layers.conv2d(p["proj"], x, stride=stride, dtype=cfg.dtype)
        shortcut, new_s["bn_proj"] = bn("bn_proj", shortcut)
    return torch.relu(y + shortcut), new_s


def _stem_conv(cfg: Config, kernel, x):
    """The 7x7/s2 stem conv, or its space-to-depth equivalent.

    s2d: input [B,H,W,C] -> [B,H/2,W/2,4C] (2x2 blocks into channels); the
    7x7/s2 conv becomes an exactly equivalent 4x4/s1 conv whose kernel is
    the 7x7 kernel zero-padded to 8x8 and re-indexed by (tap, parity),
    ``K_s2d[a,b,(dy,dx,c)] = K8[2a+dy, 2b+dx, c]``, with padding lo=1,
    hi=2.  Params stay the 7x7 kernel."""
    B, H, W, C = x.shape
    if cfg.stem == "conv7" or H % 2 or W % 2:
        return layers.conv2d({"kernel": kernel}, x, stride=2, dtype=cfg.dtype)
    xs = (
        x.to(cfg.dtype)
        .reshape(B, H // 2, 2, W // 2, 2, C)
        .permute(0, 1, 3, 2, 4, 5)
        .reshape(B, H // 2, W // 2, 4 * C)
    )
    k8 = F.pad(kernel, (0, 0, 0, 0, 0, 1, 0, 1))  # HWIO: H and W to 8
    cout = k8.shape[-1]
    ks = k8.reshape(4, 2, 4, 2, C, cout).permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * C, cout)
    return layers.conv2d({"kernel": ks}, xs, stride=1, padding=((1, 2), (1, 2)), dtype=cfg.dtype)


def _max_pool(y):
    """3x3/s2 max-pool with an explicit (1, 1) pad of -inf and no more, as
    the JAX ``reduce_window`` runs it ("SAME" would pad (0, 1) at even H
    and shift every window).  ``max_pool2d``'s own padding is exactly that
    -inf pad, and it keeps the channels_last layout without a padded copy."""
    return F.max_pool2d(y.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)


def apply(cfg: Config, params, model_state, x, *, train: bool, mesh=None):
    """x: [B, H, W, 3] -> (logits [B, num_classes] in the compute dtype,
    new_model_state)."""
    new_state: dict = {}
    y = _stem_conv(cfg, params["stem"]["kernel"], x)
    y, new_state["bn_stem"] = layers.batchnorm(
        params["bn_stem"], model_state["bn_stem"], y, train=train,
        momentum=cfg.bn_momentum, mesh=mesh, relu=True,
        ghost_slices=cfg.bn_ghost_slices,
    )
    y = _max_pool(y)
    for stage, n_blocks in enumerate(cfg.stage_sizes):
        for block in range(n_blocks):
            key = f"stage{stage}/block{block}"
            stride = 2 if (stage > 0 and block == 0) else 1
            y, new_state[key] = _bottleneck_apply(
                cfg, params[key], model_state[key], y, stride=stride,
                train=train, mesh=mesh,
            )
    y = y.to(torch.float32).mean(dim=(1, 2))  # global average pool
    return layers.dense(params["head"], y, dtype=cfg.dtype), new_state


def _kernels(params) -> list:
    """Every ``kernel`` leaf (convs and the dense head) in ``jax.tree``
    order (sorted keys), as the JAX loss collects them."""
    out = []
    for k in sorted(params):
        node = params[k]
        if isinstance(node, dict):
            out.extend([node["kernel"]] if "kernel" in node else _kernels(node))
    return out


def loss_fn(cfg: Config, *, l2: float = 1e-4, mesh=None):
    """Softmax CE + ``l2`` * sum of squares of every conv/dense kernel:
    ``f(params, model_state, batch, rng) -> (loss, (new_model_state,
    metrics))`` with metrics ``loss``, ``ce`` and ``accuracy`` (detached).
    ``mesh`` sends BatchNorm through the fused statistics kernels."""

    def f(params, model_state, batch, rng):
        del rng  # ResNet draws no noise
        logits, new_state = apply(
            cfg, params, model_state, batch["image"], train=True, mesh=mesh
        )
        ce = layers.softmax_cross_entropy(logits, batch["label"])
        loss = ce
        if l2:
            loss = ce + l2 * sum(k.to(torch.float32).square().sum() for k in _kernels(params))
        acc = layers.accuracy(logits, batch["label"])
        return loss, (new_state, {"loss": loss.detach(), "ce": ce.detach(), "accuracy": acc})

    return f


def sharding_rules(cfg: Config) -> tuple:
    """No rules without ghost BN (every leaf replicated; ``--zero_opt``
    shards the slots); ghost-batch BN's per-slice running stats [S, C]
    shard over the ``slice`` axis (JAX ``sharding_rules``), so their
    update never crosses a slice."""
    if cfg.bn_ghost_slices > 0:
        from ..parallel.partitioner import PartitionSpec as P

        return ((r".*/bn[^/]*/(mean|var)$", P("slice", None)),)
    return ()
