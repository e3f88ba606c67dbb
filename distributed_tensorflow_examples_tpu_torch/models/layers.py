"""Functional layers over plain dicts of tensors.

The port of ``distributed_tensorflow_examples_tpu/models/layers.py``:
initialisers (the JAX draws, from the same keys), dense, conv2d,
batchnorm, embedding, the LSTM cell, the training loss and accuracy.  Parameters keep the JAX layouts — dense
kernels [in, out], conv kernels HWIO, activations NHWC — so a tree or a
flat registry vector crosses between the two packages without a
transpose.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import bn as bn_ops
from ..parallel import collectives
from ..utils import threefry

# ----------------------------------------------------------------------------
# Initialisers: the JAX package's, drawn from the same threefry keys
# (``utils/threefry.py``), so a key gives the JAX initial values (uniform
# draws bit for bit, normal draws within a few float32 ulps).  Each scale is
# computed in float32, as ``jnp.sqrt`` of a Python float is; each draw is a
# float32 tensor on ``device``.
# ----------------------------------------------------------------------------


_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64}


def compute_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's ``compute_dtype`` string."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"compute_dtype {name!r} not in {sorted(_DTYPES)}") from None


def _sqrt32(x: float) -> torch.Tensor:
    """``jnp.sqrt(x)`` for a Python float: the float32 square root of
    float32(x), as a 0-d float32 tensor (on the CPU; it broadcasts)."""
    return torch.tensor(np.sqrt(np.float32(x)), dtype=torch.float32)


def glorot_uniform(key, shape, *, device="cpu"):
    """U[-l, l], l = sqrt(6 / (fan_in + fan_out)) over the last two dims."""
    limit = _sqrt32(6.0 / (shape[-2] + shape[-1])).item()
    return threefry.uniform(key, shape, -limit, limit, device)


def he_normal_conv(key, shape, *, device="cpu"):
    """He init for HWIO conv kernels (fan_in = h*w*cin)."""
    std = _sqrt32(2.0 / (shape[0] * shape[1] * shape[2]))
    return threefry.normal(key, shape, device) * std.to(device)


def he_normal(key, shape, in_axis=-2, *, device="cpu"):
    """He (fan-in) init for dense kernels."""
    std = _sqrt32(2.0 / shape[in_axis])
    return threefry.normal(key, shape, device) * std.to(device)


def uniform_embedding(key, shape, scale=None, *, device="cpu"):
    """word2vec-style U[-1/dim, 1/dim] embedding init."""
    scale = scale if scale is not None else 1.0 / shape[-1]
    return threefry.uniform(key, shape, -scale, scale, device)


def dense_init(key, in_dim: int, out_dim: int, *, use_bias: bool = True,
               init: str = "glorot", device="cpu"):
    """Kernel [in, out] from the first of ``split(key)``: glorot-uniform
    (the default) or "he" (fan-in normal); zero bias."""
    kr, _ = threefry.split(key)
    if init == "he":
        kernel = he_normal(kr, (in_dim, out_dim), device=device)
    elif init == "glorot":
        kernel = glorot_uniform(kr, (in_dim, out_dim), device=device)
    else:
        raise ValueError(f"unknown dense init {init!r}")
    p = {"kernel": kernel}
    if use_bias:
        p["bias"] = np.zeros((out_dim,), np.float32)
    return p


def conv_init(key, kh: int, kw: int, cin: int, cout: int, *, use_bias: bool = True,
              device="cpu"):
    p = {"kernel": he_normal_conv(key, (kh, kw, cin, cout), device=device)}
    if use_bias:
        p["bias"] = np.zeros((cout,), np.float32)
    return p


def embedding_init(key, vocab: int, dim: int, *, device="cpu"):
    return {"table": uniform_embedding(key, (vocab, dim), device=device)}


def lstm_cell_init(key, in_dim: int, hidden: int, *, device="cpu"):
    """Kernel [in + hidden, 4 * hidden] glorot-uniform from the first of
    ``split(key)``; zero bias."""
    kr, _ = threefry.split(key)
    return {
        "kernel": glorot_uniform(kr, (in_dim + hidden, 4 * hidden), device=device),
        "bias": np.zeros((4 * hidden,), np.float32),
    }


def as_numpy(tree):
    """A tree of tensors and numpy arrays as float32 numpy arrays on the
    host (the form ``init_numpy`` hands to ``bridge``)."""
    if isinstance(tree, dict):
        return {k: as_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree, np.float32)


def batchnorm_init(c: int, *, ghost_slices: int = 0):
    """(params, stats): unit scale, zero bias; running mean 0, var 1, with a
    leading per-slice dim [S, C] when ``ghost_slices > 0``."""
    params = {"scale": np.ones((c,), np.float32), "bias": np.zeros((c,), np.float32)}
    shape = (ghost_slices, c) if ghost_slices > 0 else (c,)
    stats = {"mean": np.zeros(shape, np.float32), "var": np.ones(shape, np.float32)}
    return params, stats


# ----------------------------------------------------------------------------
# Dense and conv
# ----------------------------------------------------------------------------


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


def _conv_pads(padding, size, window, strides):
    """((lo, hi), (lo, hi)) over H and W, as ``lax.conv_general_dilated``
    reads ``padding``: "SAME" (out = ceil(in / stride), the odd pixel of
    padding on the high side), "VALID", or explicit pairs."""
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        pads = []
        for n, k, s in zip(size, window, strides):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    return tuple((int(lo), int(hi)) for lo, hi in padding)


def conv2d(params, x, *, stride=1, padding="SAME", dtype=None):
    """NHWC x HWIO -> NHWC, in ``dtype`` (operands cast to it, output in it,
    as the JAX compute-dtype conv) or float32.  The convolution itself is
    cuDNN's (``F.conv2d``): the kernel is permuted to OIHW channels_last,
    and the NHWC activation is read as the channels_last NCHW tensor it
    already is in memory, so NHWC <-> NCHW costs nothing and the output
    stays NHWC-contiguous.  Symmetric padding goes to the convolution;
    asymmetric "SAME" padding (stride 2 over an even size) is an explicit
    zero pad first."""
    k = params["kernel"]
    dt = dtype or torch.float32
    strides = (stride, stride) if isinstance(stride, int) else tuple(stride)
    (hlo, hhi), (wlo, whi) = _conv_pads(padding, x.shape[1:3], k.shape[:2], strides)
    w = k.permute(3, 2, 0, 1).to(dtype=dt, memory_format=torch.channels_last)
    xn = x.to(dt).permute(0, 3, 1, 2)
    if hlo == hhi and wlo == whi:
        y = F.conv2d(xn, w, stride=strides, padding=(hlo, wlo))
    else:
        y = F.conv2d(F.pad(xn, (wlo, whi, hlo, hhi)), w, stride=strides)
    y = y.permute(0, 2, 3, 1)
    if "bias" in params:
        y = y + params["bias"].to(dt)
    return y


# ----------------------------------------------------------------------------
# BatchNorm (params + running stats threaded through model_state)
# ----------------------------------------------------------------------------


def batchnorm(
    params, stats, x, *, train: bool, momentum=0.9, eps=1e-5, mesh=None,
    relu: bool = False, ghost_slices: int = 0,
):
    """Returns ``(y, new_stats)`` for x [..., C], as the JAX ``batchnorm``:

    - train with a ``mesh``: the fused statistics path (``ops/bn.py``: the
      B6/B7 kernels on the card, under a custom backward);
    - train without: one-pass f32 statistics, clamped biased variance,
      autograd through them; under data parallelism the global batch's
      (sums all-reduced over the ranks, ``collectives.psum``);
    - eval: the running stats ([S, C] ghost stats by the law of total
      variance).

    The running stats update as ``momentum * old + (1 - momentum) * new``
    (the reverse of ``nn.BatchNorm2d``'s convention, and with the biased
    variance).  ``relu`` applies ReLU inside the layer; on the fused path
    the backward then recomputes the mask in the kernel.  Ghost-batch
    training waits for the port's item A8b-2b."""
    if train and ghost_slices > 0:
        raise NotImplementedError(
            "ghost-batch BN training (bn_ghost_slices > 0, statistics scoped to "
            "a 'slice' mesh axis) waits for the port's item A8b-2b"
        )
    if train:
        if mesh is not None:
            y, mean, var = bn_ops.batchnorm_train(
                params["scale"], params["bias"], x, eps, mesh, relu
            )
            return y, {
                "mean": momentum * stats["mean"] + (1 - momentum) * mean,
                "var": momentum * stats["var"] + (1 - momentum) * var,
            }
        axes = tuple(range(x.dim() - 1))
        xf = x.to(torch.float32)
        # The global batch's moments, as GSPMD makes JAX's mean over a
        # batch sharded on 'data': sums all-reduced with autograd (the
        # identity on one rank), over the global count.
        sums = collectives.psum(
            torch.stack([xf.sum(dim=axes), xf.square().sum(dim=axes)]), tag="bn")
        n = (x.numel() // x.shape[-1]) * collectives.axis_size()
        mean, mean_sq = sums[0] / n, sums[1] / n
        # Clamp: f32 cancellation can push E[x^2]-E[x]^2 slightly negative.
        var = torch.clamp(mean_sq - mean.square(), min=0.0)
        new_stats = {
            "mean": momentum * stats["mean"] + (1 - momentum) * mean.detach(),
            "var": momentum * stats["var"] + (1 - momentum) * var.detach(),
        }
    else:
        mean, var = stats["mean"], stats["var"]
        if mean.dim() == 2:
            # Ghost-trained [S, C] stats: the global moments by the law of
            # total variance (mean of the variances + variance of the means).
            gmean = mean.mean(dim=0)
            var = var.mean(dim=0) + (mean - gmean).square().mean(dim=0)
            mean = gmean
        new_stats = stats
    inv = torch.rsqrt(var + eps) * params["scale"]
    dt = x.dtype
    y = (x - mean.to(dt)) * inv.to(dt) + params["bias"].to(dt)
    if relu:
        y = torch.relu(y)
    return y, new_stats


# ----------------------------------------------------------------------------
# LSTM cell (the legacy BasicLSTMCell)
# ----------------------------------------------------------------------------


def lstm_cell(params, carry, x, *, forget_bias=1.0, dtype=None):
    """One LSTM step: ``carry = (c, h)`` -> ``((new_c, new_h), new_h)``,
    gate order i, g, f, o.  With ``dtype`` the product of ``[x, h]`` and
    the kernel, and the bias add, run in it and ``z`` returns to float32
    before the gates; without, the product runs in float32.  The carry
    stays float32."""
    c, h = carry
    k = params["kernel"]
    if dtype is not None:
        z = torch.matmul(torch.cat([x.to(dtype), h.to(dtype)], dim=-1), k.to(dtype))
        z = (z + params["bias"].to(dtype)).to(torch.float32)
    else:
        z = torch.matmul(torch.cat([x, h], dim=-1).to(torch.float32), k) + params["bias"]
    i, g, f, o = z.chunk(4, dim=-1)
    new_c = torch.sigmoid(f + forget_bias) * c + torch.sigmoid(i) * torch.tanh(g)
    new_h = torch.sigmoid(o) * torch.tanh(new_c)
    return (new_c, new_h), new_h


# ----------------------------------------------------------------------------
# Embedding, loss, metrics
# ----------------------------------------------------------------------------


def embedding_lookup(params, ids, *, dtype=None, vocab_size=None):
    """Gather rows of ``params["table"]`` as ``jnp.take`` does: a negative
    id counts from the end, and an id outside [-V, V) gives a row of NaN
    (JAX's fill mode) instead of a device-side fault.

    A table of fewer rows than ``vocab_size`` is this rank's block of a
    table sharded over ``model`` (rows ``[m n, (m + 1) n)`` on model rank
    m): the ids outside the block are masked, the block gathers its own,
    and :func:`collectives.reduce_from_model` sums the blocks' rows, so
    each row comes from its one owner and its gradient goes back to that
    owner alone.  The NaN rows are filled after the sum, once.  A whole
    table issues no collective, under any mesh."""
    t = params["table"]
    n = t.shape[0]
    v = n if vocab_size is None else vocab_size
    ids = ids.long()
    ids = torch.where(ids < 0, ids + v, ids)
    valid = (ids >= 0) & (ids < v)
    if n == v:
        rows = t[ids.clamp(0, n - 1)]
    else:
        rows = collectives.reduce_from_model(own_rows(t, ids))
    rows = torch.where(valid[..., None], rows, torch.nan)
    return rows if dtype is None else rows.to(dtype)


def own_rows(t, ids):
    """This model rank's rows of ``t`` (its block of a table sharded by
    rows over ``model``) for ``ids``: the row where the block holds the
    id, zeros elsewhere."""
    n = t.shape[0]
    local = ids - collectives.axis_index("model") * n
    mine = (local >= 0) & (local < n)
    shape = mine.shape + (1,) * (t.dim() - 1)
    return torch.where(mine.reshape(shape), t[local.clamp(0, n - 1)], 0.0)


def softmax_cross_entropy(logits, labels):
    """Mean cross-entropy: f32 logsumexp minus the gold logit, averaged
    over every row (the JAX ``layers.softmax_cross_entropy``)."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (logz - gold).mean()


def vocab_parallel_cross_entropy(logits, labels):
    """:func:`softmax_cross_entropy` over this model rank's block of the
    vocab, ``logits`` [N, V/M] holding the columns ``[m V/M, (m + 1) V/M)``:
    the max over ``model`` (no gradient), then one sum over ``model`` of
    each row's Σexp and of its gold logit, which only its owning block
    holds.  The loss comes out the same on every model rank."""
    logits = logits.to(torch.float32)
    n = logits.shape[-1]
    m = logits.detach().amax(dim=-1)
    collectives.all_reduce_max_(m, tag="model_fwd", axis_name="model")
    local = labels.long() - collectives.axis_index("model") * n
    mine = (local >= 0) & (local < n)
    gold = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    part = torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1),
                        torch.where(mine, gold, 0.0)], dim=-1)
    sums = collectives.reduce_from_model(part)
    return (torch.log(sums[..., 0]) + m - sums[..., 1]).mean()


def accuracy(logits, labels):
    """Share of rows whose argmax (the first, on a tie) is the label."""
    return (torch.argmax(logits, dim=-1) == labels.long()).to(torch.float32).mean()
