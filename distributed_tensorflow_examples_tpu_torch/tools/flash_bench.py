"""The flash and BatchNorm statistics kernels timed on the card against
their bounds, their plain versions and the PyTorch calls that compute the
same functions: the port's twin of ``tools/flash_bench.py``, and the
timers ``chip_smoke.py``'s phase 2 runs::

    python -m distributed_tensorflow_examples_tpu_torch.tools.flash_bench \\
        [--plain] [--markdown] [--kernels=flash,bn] [--device=cpu --shrink=16]

Rows (:func:`rows`): the forward (B1) at the serving, training and T 8192
shapes and non-causal, the split backward pair (B2, B3) at the training
shape, the fused backward (B4) at the T 8192 shape, the four float32-out
routes the flash ring runs every hop through at the hop shape
[16, 4096, 128] bf16 in, causal (the diagonal hop) and full (the
others; all four on the tensor cores), and the statistics kernels (B6, B7)
at ResNet-50's stem and summed over its 53 BatchNorm shapes at batch
256, 224^2.  Each flash row's route is what the built library reports it
launches (``kernel_route``; "plain" without a card).  Columns: the
kernel's ms (CUDA events over many launches, warm), the bound (the
larger of the bytes each input read and each output written once over
the memory rate and the operations over the peak rate for their type:
the tensor cores' for bf16 products, else float32's) and what binds it,
the kernel's share of the bound, TFLOP/s, the plain version's ms (with
``--plain``), the library's ms and the launches a step or apply on the
main path where the path fixes them.  Below the rows, each BN kernel's
device time a call at each distinct shape from ``torch.profiler`` and its
sum over the step (:func:`time_bn`: the events' ms of small shapes read
the wrapper's host time).  The library is SDPA and its
backward (float32 inputs for the float32-out rows) and
``torch.batch_norm_stats`` / ``torch.batch_norm_backward_reduce``:
yardsticks only, the port calls none of them.  ``--markdown`` prints
``PERF.md``-ready rows; every printout names the card and its power
limit.  ``--device=cpu`` times the plain versions on the host (the
wrappers take the plain path on CPU tensors) at shapes cut by
``--shrink``: a CPU run says nothing about the card.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import sys
import time

import torch

#: One H100 SXM's published peaks (NVIDIA's data sheet, dense, at 700 W).
H100_BF16_FLOPS = 989e12  # tensor cores
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12

#: The backward kernels' work, for :func:`flash_bound_ms`.
BWD_WORK = {
    "flash_dq": dict(products=3, tiles_in=4, tiles_out=1, rows_in=2, rows_out=0),
    "flash_dkv": dict(products=4, tiles_in=4, tiles_out=2, rows_in=2, rows_out=0),
    # q.k^T, do.v^T, p^T.do, ds^T.q and ds.k once per pair; dq, dk, dv out.
    "flash_fused_bwd": dict(products=5, tiles_in=4, tiles_out=3, rows_in=2, rows_out=0),
}
#: Flash kernels in the order of the hop rows.
HOP_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fused_bwd")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls
    (the host clock when no card is up: a CPU run)."""
    for _ in range(warmup):
        fn()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_flops(bh: int, t: int, d: int, causal: bool, products: int = 2) -> int:
    """Operations of ``products`` [T, D]-by-pair matrix products over the
    (causal: visible) score pairs."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return products * 2 * bh * pairs * d


def flash_bound_ms(
    bh: int, t: int, d: int, dtype, causal: bool, *,
    products: int = 2, tiles_in: int = 3, tiles_out: int = 1,
    rows_in: int = 0, rows_out: int = 1, out_dtype=None,
) -> tuple[float, str]:
    """The least time for a flash function on these inputs: ``products``
    [T, D]-by-pair matrix products over the (causal: visible) score pairs
    at the input dtype's peak, against ``tiles_in`` [BH, T, D] tensors
    read once, ``tiles_out`` written once (in ``out_dtype``, default the
    input's), and ``rows_in``/``rows_out`` f32 [BH, T] rows (lse, delta)
    at the memory rate.  Forward: q.k^T and p.v, q/k/v in, o and lse out.
    dq: q.k^T, do.v^T and ds.k.  dk/dv: q.k^T, do.v^T, p^T.do and ds^T.q.
    Both read q, k, v, do, lse and delta."""
    flops = flash_flops(bh, t, d, causal, products)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    esize = torch.tensor([], dtype=dtype).element_size()
    osize = torch.tensor([], dtype=out_dtype or dtype).element_size()
    nbytes = (tiles_in * esize + tiles_out * osize) * bh * t * d + (rows_in + rows_out) * bh * t * 4
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def _device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def route_of(flash, name: str, in_dtype, out_dtype) -> str:
    """The kernel the built library of ``name`` takes for these dtypes,
    as it reports it: "tensor cores" or "CUDA cores"; "plain" without a
    card, where no library is built and the wrappers run the plain
    versions."""
    if not torch.cuda.is_available():
        return "plain"
    return "tensor cores" if flash.kernel_route(name, in_dtype, out_dtype)[0] else "CUDA cores"


def _card_ms(fn, iters: int, warmup: int = 2):
    """:func:`time_ms` on the card; None (not measured) in a CPU run, where
    a wrapper would run its plain version and a library call the CPU's."""
    return time_ms(fn, iters, warmup) if torch.cuda.is_available() else None


def _tflops(flops: int, ms) -> float | None:
    return None if ms is None else flops / (ms * 1e-3) / 1e12


def bwd_inputs(flash, bh, t, d, dtype, causal, seed):
    """q, k, v, do and the saved state (lse from the forward, delta =
    rowsum(do*o)) both backward versions take, on the card (else the
    CPU)."""
    dev = _device()
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn(bh, t, d, device=dev, generator=g).to(dtype) for _ in range(4))
    o, lse = flash.fwd_call(q, k, v, causal=causal)
    return q, k, v, do, lse, flash.compute_delta(do, o)


def _sdpa_bwd_ms(args, bh, t, d, causal, iters, dtype=None) -> float:
    """SDPA's backward (dq, dk, dv together) at ``args``' q, k, v, do (cast
    to ``dtype``)."""
    import torch.nn.functional as F

    q4, k4, v4 = (x.view(1, bh, t, d).to(dtype or x.dtype).detach().requires_grad_()
                  for x in args[:3])
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    do4 = args[3].view(1, bh, t, d).to(o4.dtype)
    return _card_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True),
                    iters=iters)


def time_flash(flash, bh, t, d, dtype, causal, *, plain: bool = True) -> dict:
    """The forward kernel, its plain version, SDPA and the bound at one
    shape."""
    import torch.nn.functional as F

    dev = _device()
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(bh, t, d, device=dev, generator=g).to(dtype) for _ in range(3))
    ms = _card_ms(lambda: flash.fwd_call(q, k, v, causal=causal), iters=20)
    plain_ms = (time_ms(lambda: flash.fwd_plain(q, k, v, causal=causal), iters=3, warmup=1)
                if plain else None)
    q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
    library_ms = _card_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal), iters=20)
    bound_ms, bound_by = flash_bound_ms(bh, t, d, dtype, causal)
    tflops = _tflops(flash_flops(bh, t, d, causal), ms)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, tflops=tflops)


def time_flash_bwd(flash, bh, t, d, dtype, causal, *, plain: bool = True) -> dict:
    """Kernel, plain version, SDPA's backward and the bound for dq and
    dk/dv at one shape."""
    args = bwd_inputs(flash, bh, t, d, dtype, causal, seed=2)
    sdpa_bwd_ms = _sdpa_bwd_ms(args, bh, t, d, causal, iters=20)
    out = {}
    for name, call, plain_fn in (
        ("flash_dq", flash.dq_call, flash.dq_plain),
        ("flash_dkv", flash.dkv_call, flash.dkv_plain),
    ):
        ms = _card_ms(lambda: call(*args, causal=causal), iters=20)
        plain_ms = (time_ms(lambda: plain_fn(*args, causal=causal), iters=2, warmup=1)
                    if plain else None)
        bound_ms, bound_by = flash_bound_ms(bh, t, d, dtype, causal, **BWD_WORK[name])
        tflops = _tflops(flash_flops(bh, t, d, causal, BWD_WORK[name]["products"]), ms)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_bwd_ms,
                         bound_ms=bound_ms, bound_by=bound_by, tflops=tflops)
    return out


def time_fused_bwd(flash, bh, t, d, dtype, causal, *, plain: bool = True) -> dict:
    """The fused kernel, its plain version, SDPA's backward and the bound at
    one shape, and the split pair (dq + dk/dv) there for the 7 -> 5
    product trade."""
    args = bwd_inputs(flash, bh, t, d, dtype, causal, seed=4)
    sdpa_bwd_ms = _sdpa_bwd_ms(args, bh, t, d, causal, iters=10)
    ms = _card_ms(lambda: flash.fused_bwd_call(*args, causal=causal), iters=5, warmup=1)
    dq_ms = _card_ms(lambda: flash.dq_call(*args, causal=causal), iters=5, warmup=1)
    dkv_ms = _card_ms(lambda: flash.dkv_call(*args, causal=causal), iters=5, warmup=1)
    plain_ms = (time_ms(lambda: flash.fused_bwd_plain(*args, causal=causal), iters=1, warmup=1)
                if plain else None)
    bound_ms, bound_by = flash_bound_ms(bh, t, d, dtype, causal, **BWD_WORK["flash_fused_bwd"])
    split_bound = sum(flash_bound_ms(bh, t, d, dtype, causal, **BWD_WORK[k])[0]
                      for k in ("flash_dq", "flash_dkv"))
    tflops = _tflops(flash_flops(bh, t, d, causal, products=5), ms)
    ws_walk, ws_reduce = flash.fused_dq_workspace_bytes(bh, t, d, causal=causal)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_bwd_ms, bound_ms=bound_ms,
                bound_by=bound_by, split_dq_ms=dq_ms, split_dkv_ms=dkv_ms,
                split_bound_ms=split_bound, tflops=tflops, dq_workspace_bytes=ws_walk,
                dq_reduce_bytes=ws_reduce, slices=flash.fused_slices(bh, t))


def time_hop_routes(flash, bh: int = 16, t: int = 4096, d: int = 128, *,
                    plain: bool = False) -> dict:
    """Each flash kernel at a ring hop's shape, bf16 in: the float32-out
    route the hops take (``f32_ms``; ``route`` as :func:`route_of` reads
    it: each kernel's f32-out tensor-core instance) beside the bf16-out
    tensor-core kernel
    (``bf16_ms``), causal (the diagonal hop) and full (the others), with
    SDPA (and its backward) at float32 inputs as the float32 rows'
    library; ``{kernel: {"causal"|"full": row}}``."""
    import torch.nn.functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    out: dict = {name: {} for name in HOP_KERNELS}
    for causal in (True, False):
        kind = "causal" if causal else "full"
        args = bwd_inputs(flash, bh, t, d, bf16, causal, seed=14)
        q, k, v = args[:3]
        calls = {
            "flash_fwd": (lambda o: flash.fwd_call(q, k, v, causal=causal, out_dtype=o),
                          lambda o: flash.fwd_plain(q, k, v, causal=causal, out_dtype=o)),
            "flash_dq": (lambda o: flash.dq_call(*args, causal=causal, out_dtype=o),
                         lambda o: flash.dq_plain(*args, causal=causal, out_dtype=o)),
            "flash_dkv": (lambda o: flash.dkv_call(*args, causal=causal, out_dtype=o),
                          lambda o: flash.dkv_plain(*args, causal=causal, out_dtype=o)),
            "flash_fused_bwd": (
                lambda o: flash.fused_bwd_call(*args, causal=causal, out_dtype=o),
                lambda o: flash.fused_bwd_plain(*args, causal=causal, out_dtype=o)),
        }
        q4, k4, v4 = (x.view(1, bh, t, d).float() for x in (q, k, v))
        sdpa_f32 = _card_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal),
                            iters=3, warmup=1)
        del q4, k4, v4
        sdpa_bwd_f32 = _sdpa_bwd_ms(args, bh, t, d, causal, iters=3, dtype=f32)
        for name, (call, plain_fn) in calls.items():
            work = BWD_WORK.get(name, {})
            # One count for both, so the host's share of the events' span
            # weighs on them alike (an f32 route is as short as its bf16 one).
            f32_ms = _card_ms(lambda: call(f32), iters=10, warmup=2)
            bf16_ms = _card_ms(lambda: call(bf16), iters=10, warmup=2)
            bound_ms, bound_by = flash_bound_ms(bh, t, d, bf16, causal, out_dtype=f32, **work)
            out[name][kind] = dict(
                f32_ms=f32_ms, bf16_ms=bf16_ms, route=route_of(flash, name, bf16, f32),
                bound_ms=bound_ms, bound_by=bound_by,
                tflops=_tflops(flash_flops(bh, t, d, causal, work.get("products", 2)), f32_ms),
                library_ms=sdpa_f32 if name == "flash_fwd" else sdpa_bwd_f32,
                plain_ms=(time_ms(lambda: plain_fn(f32), iters=1, warmup=1)
                          if plain else None))
        del args, q, k, v
    return out


def resnet50_bn_shapes(batch: int, image: int) -> list[tuple[tuple, bool]]:
    """(NHWC shape, relu) of every BatchNorm of one ResNet-50 v1.5 step, in
    the order the forward runs them: the stem, then per bottleneck bn1 and
    bn2 (ReLU), bn3 and, in each stage's first block, bn_proj (no ReLU)."""
    side = image // 2  # after the stride-2 stem
    out = [((batch, side, side, 64), True)]
    side //= 2  # the max-pool
    cin = 64
    for stage, n_blocks in enumerate((3, 4, 6, 3)):
        mid = 64 * 2 ** stage
        for block in range(n_blocks):
            stride = 2 if stage > 0 and block == 0 else 1
            out.append(((batch, side, side, mid), True))
            side //= stride
            out.append(((batch, side, side, mid), True))
            out.append(((batch, side, side, 4 * mid), False))
            if cin != 4 * mid or stride == 2:
                out.append(((batch, side, side, 4 * mid), False))
            cin = 4 * mid
    return out


def bn_bound_ms(shape, dtype, *, backward: bool, relu: bool = False) -> tuple[float, str]:
    """The least time for a BN statistics call: the activation (and, in
    the backward, the upstream gradient) read once plus the (1, C) f32
    vectors in and out, against its f32 operations at the f32 rate (3 an
    element forward: add, multiply, add; backward 5: subtract, multiply,
    add, multiply-add, plus 4 for the ReLU mask: multiply, add, compare,
    multiply)."""
    n = math.prod(shape)
    c = shape[-1]
    esize = torch.tensor([], dtype=dtype).element_size()
    if backward:
        nbytes, ops = 2 * n * esize + 6 * c * 4, (9 if relu else 5) * n
    else:
        nbytes, ops = n * esize + 2 * c * 4, 3 * n
    ops_ms, bytes_ms = ops / H100_F32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bn_inputs(bn, x, do):
    """mean, inv, scale, bias for the backward statistics of x (eps 1e-5),
    from the plain forward statistics."""
    c = x.shape[-1]
    s, ss = bn.bn_stats_plain(x)
    n = x.numel() // c
    mean = s[0] / n
    inv = torch.rsqrt(torch.clamp(ss[0] / n - mean * mean, min=0.0) + 1e-5)
    scale = torch.linspace(0.5, 1.5, c, device=x.device)
    bias = torch.linspace(-1.0, 1.0, c, device=x.device)
    return mean, inv, scale, bias


def kernel_us(calls: list, kernels: tuple, iters: int = 10):
    """Device us of one call of each zero-argument function in ``calls``,
    from ``torch.profiler``: each runs ``iters`` times, in order, in one
    window, and its calls' kernel rows (the rows whose names hold one of
    ``kernels``, in order of start) are summed over ``iters``.  Raises
    unless every call launched exactly ``len(kernels)`` such rows.  None
    without a card."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    from .profile_step import load

    for fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            for _ in range(iters):
                fn()
        torch.cuda.synchronize()
    rows = sorted((r for r in load(prof).device if any(k in r[0] for k in kernels)),
                  key=lambda r: r[1])
    per = iters * len(kernels)
    if len(rows) != per * len(calls):
        raise RuntimeError(f"{len(calls)} x {iters} calls of {len(kernels)} kernel(s) {kernels} "
                           f"each; the trace holds {len(rows)} of their rows")
    return [sum(e - s for _n, s, e in rows[i * per:(i + 1) * per]) / iters
            for i in range(len(calls))]


#: The kernels one call of each BN wrapper launches (trace names).
BN_KERNELS = {"bn_stats": ("bn_stats_onepass",),
              "bn_bwd_stats": ("bn_bwd_stats_partial", "bn_stats_finalize")}


def time_bn(bn, batch: int = 256, image: int = 224, *, plain: bool = True) -> dict:
    """Each BN kernel, its plain version and its PyTorch yardstick, timed
    at the stem's shape and summed over the 53 BatchNorm shapes of one
    ResNet-50 step, with the bound beside each.  The ms are CUDA events
    around ten calls back to back, so where a call's device time is below
    the wrapper's host time they read the host's rate; beside them each
    kernel's device time (:func:`kernel_us`) at every distinct shape:
    ``device`` rows [shape, relu (B7; None for B6), calls in a step, us a
    call, bound us] and their sum ``step_device_ms``.  The inputs are
    views of one buffer; a shape that fits the 50 MB L2 is read warm on
    repeats."""
    shapes = resnet50_bn_shapes(batch, image)
    dtype = torch.bfloat16
    dev = _device()
    biggest = max(math.prod(sh) for sh, _r in shapes)
    g = torch.Generator(device=dev).manual_seed(3)
    xbuf = (torch.randn(biggest, device=dev, generator=g) * 2 + 0.5).to(dtype)
    dbuf = torch.randn(biggest, device=dev, generator=g).to(dtype)
    args = {}  # (shape, relu) -> (do, x, mean, inv, scale, bias)
    for shape, _relu in shapes:
        n = math.prod(shape)
        x, do = xbuf[:n].view(shape), dbuf[:n].view(shape)
        args[shape] = (do, x, *bn_inputs(bn, x, do))

    def fns(shape, relu):
        """kernel, plain and yardstick calls of both kernels at one shape."""
        do, x, mean, inv, scale, bias = args[shape]
        xc, dc = x.permute(0, 3, 1, 2), do.permute(0, 3, 1, 2)  # channels_last NCHW
        lstats = torch.batch_norm_stats(xc, 1e-5) if dev == "cuda" else None
        return {
            "bn_stats": (lambda: bn.bn_stats(x), lambda: bn.bn_stats_plain(x),
                         lambda: torch.batch_norm_stats(xc, 1e-5)),
            "bn_bwd_stats": (
                lambda: bn.bn_bwd_stats(do, x, mean, inv, scale, bias, relu=relu),
                lambda: bn.bn_bwd_stats_plain(do, x, mean, inv, scale, bias, relu=relu),
                # No ReLU mask in the yardstick: it reduces dy as given.
                lambda: torch.batch_norm_backward_reduce(dc, xc, *lstats, scale, True, True, True)),
        }

    def one(name: str) -> dict:
        keys = ("ms", "plain_ms", "library_ms", "bound_ms")
        acc, stem = dict.fromkeys(keys, 0.0), None
        for shape, relu in shapes:
            call, plain_call, lib_call = fns(shape, relu)[name]
            bound_ms, bound_by = bn_bound_ms(shape, dtype, backward=name == "bn_bwd_stats",
                                             relu=relu)
            row = dict(ms=_card_ms(call, iters=10), bound_ms=bound_ms, bound_by=bound_by,
                       plain_ms=time_ms(plain_call, iters=3, warmup=1) if plain else None,
                       library_ms=_card_ms(lib_call, iters=10))
            for key in keys:
                acc[key] = None if row[key] is None or acc[key] is None else acc[key] + row[key]
            stem = stem or row
        distinct = collections.Counter(
            (shape, relu if name == "bn_bwd_stats" else None) for shape, relu in shapes)
        us = kernel_us([fns(shape, bool(relu))[name][0] for shape, relu in distinct],
                       BN_KERNELS[name])
        device = [[list(shape), relu, n, None if us is None else us[j],
                   bn_bound_ms(shape, dtype, backward=name == "bn_bwd_stats",
                               relu=bool(relu))[0] * 1e3]
                  for j, ((shape, relu), n) in enumerate(distinct.items())]
        return dict(stem, shape=list(shapes[0][0]), shapes=len(shapes), step_ms=acc["ms"],
                    step_plain_ms=acc["plain_ms"], step_library_ms=acc["library_ms"],
                    step_bound_ms=acc["bound_ms"], device=device,
                    step_device_ms=None if us is None else sum(
                        n * u for _s, _r, n, u, _b in device) / 1e3)

    out = {name: one(name) for name in ("bn_stats", "bn_bwd_stats")}
    del xbuf, dbuf, args
    return out


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def _share(r: dict) -> str:
    """The kernel's share of its bound (bound ms over kernel ms)."""
    return "-" if r["ms"] is None else f"{r['bound_ms'] / r['ms']:.0%}"


def describe(label: str, r: dict, launches=None) -> str:
    """One printed row: the kernel's ms, TFLOP/s, bound, share of the
    bound, plain and library ms, launches."""
    tf = f" ({r['tflops']:.1f} TFLOP/s)" if r.get("tflops") is not None else ""
    return (f"{label}: kernel {_ms(r['ms'])} ms{tf}, bound {_ms(r['bound_ms'])} ms "
            f"({r['bound_by']}; {_share(r)} of it), plain "
            f"{_ms(r.get('plain_ms'))} ms, library {_ms(r.get('library_ms'))} ms"
            + (f", {launches} launches" if launches is not None else ""))


def describe_bn_device(name: str, r: dict) -> list[str]:
    """Printed lines of a :func:`time_bn` row's device times: a call's us
    at each distinct shape and the step's sum."""
    def us(x):
        return "not measured" if x is None else f"{x:.2f}"

    lines = [f"{name} device us a call (torch.profiler) x calls a step, bound us: " + ", ".join(
        f"{shape}{' relu' if relu else ''} {us(u)} x {n} (bound {b:.2f})"
        for shape, relu, n, u, b in r["device"])
        + f"; step {_ms(r['step_device_ms'])} ms of kernel time against "
        f"{_ms(r['step_ms'])} ms by events, bound {r['step_bound_ms']:.4f} ms"]
    return lines


def rows(flash, bn, *, plain: bool, shrink: int = 1, kernels=("flash", "bn")) -> list:
    """Every row of the module docstring: [(kernel, shape text, route,
    row dict, launches a step or apply on the main path or None)];
    ``shrink`` cuts T, BH and the ResNet batch and image (a CPU run);
    ``kernels`` picks the flash rows, the BN rows or both."""
    def s(t):
        return max(16, t // shrink)

    def b(bh):
        return max(1, bh // shrink)

    bf16 = torch.bfloat16
    out = []
    if "flash" in kernels:
        for bh, t, causal, path in ((16, 2048, True, 12), (64, 2048, True, 12),
                                    (16, 8192, True, 12), (8, 2048, False, None)):
            bh, t = b(bh), s(t)
            r = time_flash(flash, bh, t, 128, bf16, causal, plain=plain)
            out.append(("flash_fwd", f"[{bh}, {t}, 128] bf16 {'causal' if causal else 'full'}",
                        route_of(flash, "flash_fwd", bf16, bf16), r, path))
        bwd = time_flash_bwd(flash, b(64), s(2048), 128, bf16, True, plain=plain)
        for name in ("flash_dq", "flash_dkv"):
            out.append((name, f"[{b(64)}, {s(2048)}, 128] bf16 causal",
                        route_of(flash, name, bf16, bf16), bwd[name], 12))
        fused = time_fused_bwd(flash, b(16), s(8192), 128, bf16, True, plain=plain)
        out.append(("flash_fused_bwd", f"[{b(16)}, {s(8192)}, 128] bf16 causal",
                    route_of(flash, "flash_fused_bwd", bf16, bf16), fused, 12))
        hops = time_hop_routes(flash, b(16), s(4096), 128, plain=plain)
        for name in HOP_KERNELS:
            for kind, h in hops[name].items():
                out.append((name, f"[{b(16)}, {s(4096)}, 128] bf16->f32 {kind}", h["route"],
                            dict(h, ms=h["f32_ms"]), None))
    if "bn" in kernels:
        bns = time_bn(bn, max(2, 256 // shrink), max(32, 224 // shrink), plain=plain)
        for name, r in bns.items():
            out.append((name, f"{r['shape']} bf16 (stem)", "CUDA cores", r, None))
            out.append((name, f"{r['shapes']} ResNet-50 shapes, summed", "CUDA cores",
                        dict(ms=r["step_ms"], plain_ms=r["step_plain_ms"],
                             library_ms=r["step_library_ms"], bound_ms=r["step_bound_ms"],
                             bound_by=r["bound_by"], device_ms=r["step_device_ms"]),
                        r["shapes"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--plain", action="store_true", help="time the plain versions too")
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--shrink", type=int, default=1,
                    help="divide T, BH and the ResNet batch and image by this")
    ap.add_argument("--kernels", default="flash,bn",
                    help="comma-separated: flash (B1-B4 and the hop routes), bn (B6, B7)")
    args = ap.parse_args(argv)
    from ..ops import bn
    from ..ops import flash_attention as flash
    from .profile_step import card_line

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("flash_bench: no CUDA device (--device=cpu times the plain versions)",
                  file=sys.stderr)
            return 2
        from ..ops import _build

        _build.build(["flash_fwd", "flash_bwd", "flash_fused_bwd", "bn_stats"])
        card = card_line()
    else:
        card = "cpu (plain versions, host clock)"
    table = rows(flash, bn, plain=args.plain or args.device == "cpu", shrink=args.shrink,
                 kernels=args.kernels.split(","))
    if args.markdown:
        print(f"| kernel | shape | route | ms | bound ms (by) | share | TFLOP/s | plain ms "
              f"| library ms | launches | card |")
        print("|" + "---|" * 11)
    for name, shape, route, r, launches in table:
        if args.markdown:
            tf = "-" if r.get("tflops") is None else f"{r['tflops']:.1f}"
            print(f"| {name} | {shape} | {route} | {_ms(r['ms'])} | {_ms(r['bound_ms'])} "
                  f"({r['bound_by']}) | {_share(r)} | {tf} | "
                  f"{_ms(r.get('plain_ms'))} | {_ms(r.get('library_ms'))} | "
                  f"{launches if launches is not None else '-'} | {card} |")
        else:
            print(describe(f"{name} {shape} ({route})", r, launches) + f" [{card}]")
    for name, _shape, _route, r, _launches in table:
        for line in describe_bn_device(name, r) if "device" in r else ():
            print(f"{line} [{card}]")
    print(json.dumps({"card": card, "rows": [
        {"kernel": n, "shape": sh, "route": rt, "launches": la,
         **{k: v for k, v in r.items() if isinstance(v, (int, float, str)) or v is None}}
        for n, sh, rt, r, la in table]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
