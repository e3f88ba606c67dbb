"""BatchNorm(+ReLU) statistics: hand-written CUDA kernels for Hopper, their
plain PyTorch versions, and the training-mode batchnorm built on them.

The port of ``distributed_tensorflow_examples_tpu/ops/bn.py``.  The kernels
(``csrc/bn_stats.cu``) replace the Pallas TPU kernels ``_stats_kernel``
(:func:`bn_stats`: per-channel sum(x) and sum(x*x) in f32, one pass) and
``_bwd_stats_kernel`` (:func:`bn_bwd_stats`: s1 = sum(dy) and
s2 = sum(dy*xhat), with the ReLU mask recomputed from xhat inside the
kernel so the masked gradient never exists in device memory).  The source
note says what bounds them on the card and how the design answers that.

Both take the activation as [M, C] row-major (M = N*H*W): a contiguous
NHWC tensor, or a channels_last NCHW one seen through ``permute(0, 2, 3,
1)``.  A CUDA tensor launches the kernel and must be laid out so (the
wrapper raises rather than copy); a CPU tensor takes the plain version
(:func:`bn_stats_plain`, :func:`bn_bwd_stats_plain`); any other device
raises.  Nothing falls back.

:func:`batchnorm_train` is the JAX ``batchnorm_train`` custom VJP as a
``torch.autograd.Function``: the forward's statistics from
:func:`bn_stats` (or, with ``IMPL = "matmul"``, :func:`mm_stats`), its
elementwise output in ``x.dtype``; the backward's sums from
:func:`bn_bwd_stats` (or :func:`mm_bwd_stats`), dx elementwise in
``x.dtype``, and (dgamma, dbeta) = (s2, s1) in f32.  Backward math
(biased variance, matching the E[x^2]-E[x]^2 forward): xhat = (x - mean) *
inv; dy = do * relu_mask; dx = gamma * inv * (dy - s1/n - xhat * s2/n).

SyncBN (a mesh whose ``data`` axis is larger than 1, JAX's
``_shard_stats``): each rank runs the kernel on its own rows, and the
(1, C) partial sums are sum-all-reduced over the mesh's data group
(``Mesh.group``, ``parallel/mesh.py``) before the division by the global count
(local rows x ranks), as JAX's ``_count`` reads the global array.  The
backward sums (s1, s2) likewise, and dx takes the global sums.  The
cotangents of scale and bias are the rank's LOCAL sums: the data-parallel
step then averages them with every other gradient (JAX returns the psum'd
sums because its one global loss has no later average; so does
``torch.nn.SyncBatchNorm``: local ``grad_weight``, global sums for
``grad_input``).
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel import collectives
from . import LAUNCHES, _build

#: Statistics implementation, as in the JAX package: "kernel" (the
#: hand-written reductions) or "matmul" (the reference's MXU contraction
#: forms, here as plain torch ops, kept so the switch keeps parity).
IMPL = "kernel"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: Threads of one pass-1 block (``kThreads`` in the source).
_THREADS = 256
#: Pass-1 blocks to aim for: 8 blocks of 256 threads on each of the
#: H100's 132 SMs.
_TARGET_BLOCKS = 8 * 132
#: Fewest rows a thread of pass 1 should add before a range is split again.
_MIN_ROWS_PER_THREAD = 16


def _device_of(name: str, x) -> str:
    """``x``'s device type where a kernel wrapper accepts it: cpu (the plain
    version) or cuda (the kernel)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {x.device}")
    return x.device.type


def _check_x(name: str, x) -> tuple[int, int]:
    """(M, C) of an activation [..., C] the statistics take."""
    if x.dim() < 2 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"{name} takes a non-empty [..., C] activation, got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    return x.numel() // c, c


def _check_vecs(name: str, c: int, device, **vecs) -> None:
    for key, v in vecs.items():
        if v.dtype != torch.float32 or v.numel() != c or v.device != device:
            raise ValueError(
                f"{name}: {key} must be float32 with {c} elements on {device}; got "
                f"{v.dtype} {tuple(v.shape)} on {v.device}"
            )


def launch_shape(m: int, c: int, vec: int) -> tuple[int, int, int, int]:
    """``(tx_n, strips, splits, rows_per_split)`` of pass 1 for an [m, c]
    activation read ``vec`` channels at a time: ``tx_n`` threads (a power
    of two, at most a warp) along a strip of ``tx_n * vec`` channels,
    ``256 / tx_n`` row lanes, and the rows cut into ``splits`` ranges so
    that about ``_TARGET_BLOCKS`` blocks run, each thread adding at least
    ``_MIN_ROWS_PER_THREAD`` rows."""
    groups = -(-c // vec)
    tx_n = min(32, 1 << (groups - 1).bit_length())
    strips = -(-groups // tx_n)
    ty_n = _THREADS // tx_n
    splits = max(1, min(_TARGET_BLOCKS // strips, -(-m // (ty_n * _MIN_ROWS_PER_THREAD)), 65535))
    rows = -(-m // splits)
    return tx_n, strips, -(-m // rows), rows  # no empty range at the end


def _vec(c: int, *tensors) -> int:
    """Channels per load: 16 bytes' worth when C and every pointer allow."""
    vec = 16 // tensors[0].element_size()
    if c % vec or any(t.data_ptr() % 16 for t in tensors):
        return 1
    return vec


def _cuda_checks(name: str, *tensors) -> None:
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(
            f"{name} kernel needs [M, C] row-major operands (contiguous NHWC, or "
            "channels_last NCHW permuted to NHWC); got strides "
            + ", ".join(str(t.stride()) for t in tensors)
        )


def _raise_on(name: str, err: int, x) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed with cudaError_t {err} "
            f"(shape {tuple(x.shape)}, {x.dtype})"
        )


def bn_stats(x):
    """x [..., C] -> (sum [1, C] f32, sumsq [1, C] f32): the kernel on a
    CUDA tensor, the plain version on a CPU tensor, an error otherwise."""
    m, c = _check_x("bn_stats", x)
    if _device_of("bn_stats", x) == "cpu":
        return bn_stats_plain(x)
    _cuda_checks("bn_stats", x)
    vec = _vec(c, x)
    tx_n, _strips, splits, rows = launch_shape(m, c, vec)
    fn = _build.load("bn_stats").dtx_bn_stats
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = torch.empty((2, splits, c), dtype=torch.float32, device=x.device)
    s = torch.empty((1, c), dtype=torch.float32, device=x.device)
    ss = torch.empty((1, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), ws.data_ptr(), s.data_ptr(), ss.data_ptr(), m, c,
            _DTYPE_CODES[x.dtype], vec, tx_n, splits, rows,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on("bn_stats", err, x)
    LAUNCHES["bn_stats"] += 1
    return s, ss


def bn_stats_plain(x):
    """:func:`bn_stats` in plain PyTorch: f32 column sums of x viewed as
    [M, C]."""
    _check_x("bn_stats", x)
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    return xf.sum(dim=0, keepdim=True), (xf * xf).sum(dim=0, keepdim=True)


def bn_bwd_stats(do, x, mean, inv, scale, bias, *, relu: bool):
    """(s1, s2) = (sum(dy), sum(dy * xhat)) as two [1, C] f32, with
    xhat = (x - mean) * inv and dy = do * [xhat*scale + bias > 0] computed
    in f32 in the kernel (``relu``) or dy = do.  do and x share shape and
    dtype; mean, inv, scale, bias hold C f32 values.  The kernel on CUDA
    tensors, the plain version on CPU tensors, an error otherwise."""
    m, c = _check_x("bn_bwd_stats", x)
    if do.shape != x.shape or do.dtype != x.dtype or do.device != x.device:
        raise ValueError(
            f"bn_bwd_stats: do must match x's shape, dtype and device; got "
            f"{tuple(do.shape)} {do.dtype} on {do.device} for x {tuple(x.shape)} {x.dtype}"
        )
    _check_vecs("bn_bwd_stats", c, x.device, mean=mean, inv=inv, scale=scale, bias=bias)
    if _device_of("bn_bwd_stats", x) == "cpu":
        return bn_bwd_stats_plain(do, x, mean, inv, scale, bias, relu=relu)
    _cuda_checks("bn_bwd_stats", do, x, mean, inv, scale, bias)
    vec = _vec(c, do, x)
    tx_n, _strips, splits, rows = launch_shape(m, c, vec)
    fn = _build.load("bn_stats").dtx_bn_bwd_stats
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = torch.empty((2, splits, c), dtype=torch.float32, device=x.device)
    s1 = torch.empty((1, c), dtype=torch.float32, device=x.device)
    s2 = torch.empty((1, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(
            do.data_ptr(), x.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), ws.data_ptr(), s1.data_ptr(),
            s2.data_ptr(), m, c, _DTYPE_CODES[x.dtype], vec, tx_n, splits, rows,
            int(bool(relu)), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _raise_on("bn_bwd_stats", err, x)
    LAUNCHES["bn_bwd_stats"] += 1
    return s1, s2


def bn_bwd_stats_plain(do, x, mean, inv, scale, bias, *, relu: bool):
    """:func:`bn_bwd_stats` in plain PyTorch, in f32 as the kernel does."""
    c = x.shape[-1]
    dof = do.reshape(-1, c).to(torch.float32)
    xhat = (x.reshape(-1, c).to(torch.float32) - mean.reshape(1, c)) * inv.reshape(1, c)
    if relu:
        pre = xhat * scale.reshape(1, c) + bias.reshape(1, c)
        dof = dof * (pre > 0)
    return dof.sum(dim=0, keepdim=True), (dof * xhat).sum(dim=0, keepdim=True)


def mm_stats(x):
    """Matmul-form statistics, (sum [C], sumsq [C]) f32: the JAX ``1^T.x``
    and Gram-diagonal contractions, which accumulate exact products of the
    input dtype in f32."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    return x2.sum(dim=0), (x2 * x2).sum(dim=0)


def mm_bwd_stats(do, x, mean, inv, scale, bias, *, relu: bool):
    """Matmul-form backward sums: s1 = sum(dy) and s2 folded onto the raw
    operands, s2 = inv * (diag(dy^T x) - mean * s1); the ReLU mask in
    ``x.dtype``, as the JAX form computes it."""
    c = x.shape[-1]
    do2, x2 = do.reshape(-1, c), x.reshape(-1, c)
    if relu:
        ivs = (inv * scale).to(x.dtype)
        pre = (x2 - mean.to(x.dtype)) * ivs + bias.to(x.dtype)
        do2 = do2 * (pre > 0).to(do.dtype)
    d32 = do2.to(torch.float32)
    s1 = d32.sum(dim=0)
    s2 = inv * ((d32 * x2.to(torch.float32)).sum(dim=0) - mean * s1)
    return s1, s2


def _sum_over_ranks(a, b, group):
    """(a, b), two [C] partial sums, summed over ``group`` (the mesh's data
    group) in one all-reduce when it has more than one rank."""
    if group is None or group.size == 1:
        return a, b
    both = torch.stack([a, b])
    with collectives.use_group(group):
        collectives.all_reduce_sum_(both, tag="bn")
    return both[0], both[1]


def _count(x) -> int:
    return x.numel() // x.shape[-1]


def _ranks(group) -> int:
    return 1 if group is None else group.size


def _stats_of(x, group):
    if IMPL == "matmul":
        s, ss = mm_stats(x)
    else:
        s, ss = bn_stats(x)
        s, ss = s[0], ss[0]
    s, ss = _sum_over_ranks(s, ss, group)
    n = _count(x) * _ranks(group)
    mean = s / n
    var = torch.clamp(ss / n - mean * mean, min=0.0)  # one-pass, clamped
    return mean, var


class BatchNormTrain(torch.autograd.Function):
    """``(y, mean, var)`` of training-mode batchnorm (the JAX custom VJP
    ``batchnorm_train``); y is post-ReLU when ``relu``.  mean and var feed
    the caller's running-stats update and carry no gradient."""

    @staticmethod
    def forward(ctx, scale, bias, x, eps, mesh, relu):
        group = None if mesh is None else mesh.group
        mean, var = _stats_of(x, group)
        inv = torch.rsqrt(var + eps)
        dt = x.dtype
        # The same elementwise formula and compute dtype as the no-mesh path.
        y = (x - mean.to(dt)) * (inv * scale).to(dt) + bias.to(dt)
        if relu:
            y = torch.relu(y)
        ctx.save_for_backward(scale, bias, x, mean, inv)
        ctx.relu, ctx.group = relu, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, do, _dmean, _dvar):
        scale, bias, x, mean, inv = ctx.saved_tensors
        relu = ctx.relu
        if IMPL == "matmul":
            s1, s2 = mm_bwd_stats(do, x, mean, inv, scale, bias, relu=relu)
        else:
            s1, s2 = bn_bwd_stats(
                do, x, mean, inv, scale.to(torch.float32), bias.to(torch.float32), relu=relu
            )
            s1, s2 = s1[0], s2[0]
        g1, g2 = _sum_over_ranks(s1, s2, ctx.group)
        n = _count(x) * _ranks(ctx.group)
        dt = x.dtype
        xhat = (x - mean.to(dt)) * inv.to(dt)
        dy = do
        if relu:
            pre = xhat * scale.to(dt) + bias.to(dt)
            dy = do * (pre > 0).to(dt)
        g = (scale * inv).to(dt)
        dx = g * (dy - (g1 / n).to(dt) - xhat * (g2 / n).to(dt))
        return s2, s1, dx, None, None, None  # local dgamma, dbeta; dx


def batchnorm_train(scale, bias, x, eps, mesh, relu=False):
    """(y, mean, var) of :class:`BatchNormTrain`."""
    return BatchNormTrain.apply(scale, bias, x, eps, mesh, bool(relu))
