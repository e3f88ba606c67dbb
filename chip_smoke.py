#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line) when
it fails:

1. Build: compile every CUDA kernel source in the checkout
   (``distributed_tensorflow_examples_tpu_torch/ops/csrc``: ``flash_fwd``,
   ``flash_bwd``), one ``nvcc`` per source, all started together.
2. Kernels against their plain PyTorch versions on the card, at the shapes
   the main paths give them and at the edges the kernels must also take
   (ragged T, head dims 32/64, float32 in and out, non-causal), with the
   tolerances stated below; the backward kernels must also give the same
   bits on a second run.  Then each kernel, its plain version and the
   PyTorch call computing the same function (``scaled_dot_product_attention``
   and its backward, timed as a yardstick only; the port never calls
   either) are timed with CUDA events at the main path's shape.
3. Serve end to end at full width: the flagship transformer (vocab 32000,
   dim 1024, 12 layers, 8 heads, T 2048, bf16), random weights from
   ``numpy.random.default_rng(0)`` at the JAX init's scales, published to
   a model registry, served by the port's registry-pinned replica
   (``host_serve_task``, ``attention="auto"``, ``max_batch=2``) and asked
   for one-row predicts by the port's ``ServeClient``, two of them
   concurrently.  Every answer must be finite logits [1, 2048, 32000] with
   the published step and version stamps; the flash forward must have run
   12 times per apply; one answer must match an ``attention="xla"`` apply
   of the same weights on the card.
4. Train end to end at full width: the same flagship, batch 8 x T 2048,
   through the port's training job (``examples.transformer_lm``'s
   ``run_training``: ``Experiment`` over the synthetic ``text_corpus``,
   ``attention="auto"``, clip 1.0 + AdamW 1e-3) for ``TRAIN_STEPS`` steps,
   publishing the trained weights to a registry.  The loss must start
   near ln(32000), stay finite and fall; the forward, dq and dk/dv
   kernels must each have run 12 times per step; the published version
   must hold the trained parameters bit for bit; and one step's loss and
   gradients from the initial weights on the first batch must match an
   ``attention="xla"`` step.  Last, one step under ``torch.profiler``
   gives the step's device time by kernel family and the idle share.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  The run needs one card; it exits
non-zero without one, and without the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
H100_BF16_FLOPS = 989e12  # dense tensor-core peak, SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12
#: Kernel vs plain version, same inputs, same arithmetic in another order:
#: a bf16 output may land one bf16 step away (2^-7 at |o| in [1, 2)) and a
#: p on the other side of a bf16 rounding boundary moves o by 2^-8 * p * |v|;
#: float32 outputs differ by summation order only; lse is float32 throughout.
TOL_O = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TOL_LSE = 1e-3
#: Flash kernel vs plain mha, 12 bf16 layers at full width: the two round
#: the attention output differently in every layer; 2^-3 is four bf16 steps
#: at |logit| in [2, 4).  (A CPU run of the same comparison at dim 1024,
#: T 1024 differed by at most 0.025.)
TOL_LOGITS = 0.125
#: Backward kernels vs plain versions, relative to the largest entry of the
#: plain output: bf16 outputs two bf16 steps (2^-8 relative each; p and ds
#: also round to bf16 inside the products, and a value on the other side
#: of a rounding boundary moves one term by 2^-8 of itself); float32 the
#: summation order only.
TOL_BWD = {torch.bfloat16: 8e-3, torch.float32: 2e-5}
#: The full-width training phase.
TRAIN_STEPS = 6
TRAIN_BATCH = 8
#: Flash step vs xla step from the same weights and batch, bf16 at full
#: width: the two round attention differently (p to bf16 inside the kernel,
#: the softmax output to bf16 in mha).  On an H100 (700 W) it gave a
#: loss gap of 1.2e-5 and per-leaf gradient errors up to 2.6e-3; the bounds
#: leave room for other cards' summation orders.  A kernel fault (a mask,
#: a scale, a cast) moves gradients by O(1).
TOL_TRAIN_LOSS = 1e-2
TOL_TRAIN_GRAD = 3e-2
#: Device rows of a profile that are the profiler's own markers, not work.
CUPTI_MARKERS = ("Command Buffer Full", "Activity Buffer Request")
#: Kernel families of a training step's profile, by substrings of the
#: kernel name (after the three flash kernels).
KERNEL_FAMILIES = (
    ("optimizer", ("adam", "multi_tensor_apply")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("reduce", ("reduce", "norm", "softmax", "logsumexp")),
    ("copy/cast", ("copy", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


_TYPES = {"13__nv_bfloat16S1_": "bf16->bf16", "13__nv_bfloat16f": "bf16->f32",
          "f13__nv_bfloat16": "f32->bf16", "ff": "f32->f32"}


def ptxas_report(log_text: str) -> list[str]:
    """One line per kernel instance from nvcc's ``-Xptxas -v`` log: its
    registers and spills."""
    import re

    out, name, spill = [], None, ""
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            kernel = re.search(r"(flash_(?:fwd|dq|dkv)_kernel)I", mangled)
            d = re.search(r"Li(\d+)E", mangled)
            types = next((v for k, v in _TYPES.items()
                          if re.search(r"_kernelI" + re.escape(k), mangled)), "?")
            name = f"{kernel.group(1) if kernel else mangled}<{types}, D={d.group(1) if d else '?'}>"
            continue
        if "spill" in line:
            spill = line.split(":", 1)[-1].strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers; {spill}")
            name, spill = None, ""
    return out


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound_ms(
    bh: int, t: int, d: int, dtype, causal: bool, *,
    products: int = 2, tiles_in: int = 3, tiles_out: int = 1,
    rows_in: int = 0, rows_out: int = 1,
) -> tuple[float, str]:
    """The least time for a flash function on these inputs: ``products``
    [T, D]-by-pair matrix products over the (causal: visible) score pairs
    at the dtype's peak, against ``tiles_in`` [BH, T, D] tensors read once,
    ``tiles_out`` written once, and ``rows_in``/``rows_out`` f32 [BH, T]
    rows (lse, delta) at the memory rate.  Forward: q.k^T and p.v, q/k/v
    in, o and lse out.  dq: q.k^T, do.v^T and ds.k.  dk/dv: q.k^T, do.v^T,
    p^T.do and ds^T.q.  Both read q, k, v, do, lse and delta."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = products * 2 * bh * pairs * d
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = (tiles_in + tiles_out) * bh * t * d * esize + (rows_in + rows_out) * bh * t * 4
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


#: The backward kernels' work, for :func:`flash_bound_ms`.
BWD_WORK = {
    "flash_dq": dict(products=3, tiles_in=4, tiles_out=1, rows_in=2, rows_out=0),
    "flash_dkv": dict(products=4, tiles_in=4, tiles_out=2, rows_in=2, rows_out=0),
}


def check_flash(flash, bh, t, d, dtype, causal, out_dtype=None) -> float:
    """Kernel vs plain version on one input; returns the max abs error of o."""
    g = torch.Generator(device="cuda").manual_seed(bh * 7919 + t * 31 + d)
    q, k, v = (
        torch.randn(bh, t, d, device="cuda", dtype=torch.float32, generator=g).to(dtype)
        for _ in range(3)
    )
    o, lse = flash.fwd_call(q, k, v, causal=causal, out_dtype=out_dtype)
    torch.cuda.synchronize()
    po, plse = flash.fwd_plain(q, k, v, causal=causal, out_dtype=out_dtype)
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs().max().item()
    tol = TOL_O[out_dtype or dtype]
    log(
        f"  flash_fwd [{bh}, {t}, {d}] {str(dtype)[6:]}->{str(out_dtype or dtype)[6:]} "
        f"causal={causal}: max|o - plain| = {err_o:.3e} (tol {tol:g}), "
        f"max|lse - plain| = {err_lse:.3e} (tol {TOL_LSE:g})"
    )
    if not (math.isfinite(err_o) and err_o <= tol and err_lse <= TOL_LSE):
        raise SystemExit(f"flash_fwd disagrees with its plain version at [{bh}, {t}, {d}]")
    return err_o


def time_flash(flash, bh, t, d, dtype, causal) -> dict:
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (
        torch.randn(bh, t, d, device="cuda", generator=g).to(dtype) for _ in range(3)
    )
    ms = time_ms(lambda: flash.fwd_call(q, k, v, causal=causal), iters=20)
    plain_ms = time_ms(lambda: flash.fwd_plain(q, k, v, causal=causal), iters=3, warmup=1)
    q4, k4, v4 = (x.view(1, bh, t, d) for x in (q, k, v))
    library_ms = time_ms(
        lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal), iters=20
    )
    bound_ms, bound_by = flash_bound_ms(bh, t, d, dtype, causal)
    log(
        f"  timing flash_fwd [{bh}, {t}, {d}] {str(dtype)[6:]} causal={causal}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})"
    )
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _bwd_inputs(flash, bh, t, d, dtype, causal, seed):
    """q, k, v, do on the card and the saved state (lse from the forward
    kernel, delta = rowsum(do*o)) both backward versions take."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (
        torch.randn(bh, t, d, device="cuda", generator=g).to(dtype) for _ in range(4)
    )
    o, lse = flash.fwd_call(q, k, v, causal=causal)
    return q, k, v, do, lse, flash.compute_delta(do, o)


def check_flash_bwd(flash, bh, t, d, dtype, causal, out_dtype=None, determinism=False) -> dict:
    """dq and dk/dv kernels vs their plain versions on one input, held to
    the tolerance relative to the largest plain entry; returns each
    kernel's max absolute error."""
    args = _bwd_inputs(flash, bh, t, d, dtype, causal, seed=bh * 131 + t * 7 + d)
    kw = dict(causal=causal, out_dtype=out_dtype)
    got = (flash.dq_call(*args, **kw), *flash.dkv_call(*args, **kw))
    torch.cuda.synchronize()
    want = (flash.dq_plain(*args, **kw), *flash.dkv_plain(*args, **kw))
    tol = TOL_BWD[out_dtype or dtype]
    rels, abs_errs = [], []
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if a.dtype != (out_dtype or dtype) or a.shape != b.shape:
            raise SystemExit(f"flash backward {name}: {a.dtype} {tuple(a.shape)}")
        abs_errs.append((a.float() - b.float()).abs().max().item())
        rels.append(abs_errs[-1] / max(b.float().abs().max().item(), 1e-30))
    log(
        f"  flash_dq/flash_dkv [{bh}, {t}, {d}] {str(dtype)[6:]}->"
        f"{str(out_dtype or dtype)[6:]} causal={causal}: max|Δ|/max|plain| "
        f"dq {rels[0]:.3e}, dk {rels[1]:.3e}, dv {rels[2]:.3e} (tol {tol:g})"
    )
    if not all(math.isfinite(r) and r <= tol for r in rels):
        raise SystemExit(f"flash backward disagrees with its plain version at [{bh}, {t}, {d}]")
    if determinism:
        again = (flash.dq_call(*args, **kw), *flash.dkv_call(*args, **kw))
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        log(f"  flash_dq/flash_dkv second run bitwise equal: {same}")
        if not same:
            raise SystemExit("flash backward kernels are not deterministic run to run")
    return {"flash_dq": abs_errs[0], "flash_dkv": max(abs_errs[1:])}


def time_flash_bwd(flash, bh, t, d, dtype, causal) -> dict:
    """Kernel, plain version, SDPA's backward and the bound for dq and
    dk/dv at one shape."""
    import torch.nn.functional as F

    args = _bwd_inputs(flash, bh, t, d, dtype, causal, seed=2)
    q4, k4, v4 = (x.view(1, bh, t, d).detach().requires_grad_() for x in args[:3])
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)
    do4 = args[3].view(1, bh, t, d)
    sdpa_bwd_ms = time_ms(
        lambda: torch.autograd.grad(o4, (q4, k4, v4), do4, retain_graph=True), iters=20
    )
    out = {}
    for name, call, plain in (
        ("flash_dq", flash.dq_call, flash.dq_plain),
        ("flash_dkv", flash.dkv_call, flash.dkv_plain),
    ):
        ms = time_ms(lambda: call(*args, causal=causal), iters=20)
        plain_ms = time_ms(lambda: plain(*args, causal=causal), iters=2, warmup=1)
        bound_ms, bound_by = flash_bound_ms(bh, t, d, dtype, causal, **BWD_WORK[name])
        log(
            f"  timing {name} [{bh}, {t}, {d}] {str(dtype)[6:]} causal={causal}: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa backward (dq, dk, dv "
            f"together) {sdpa_bwd_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
        )
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=sdpa_bwd_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
    return out


def serve_end_to_end(card: str) -> dict:
    """Publish, serve, ask and check (the module docstring's phase 3);
    returns the kernel launch counts of the main path's run."""
    from distributed_tensorflow_examples_tpu_torch import bridge
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.serve import (
        ModelRegistry, host_serve_task,
    )

    cfg = transformer.Config(
        vocab_size=32000, dim=1024, n_layers=12, n_heads=8,
        max_seq_len=2048, attention="auto",
    )
    t = cfg.max_seq_len
    t0 = time.perf_counter()
    flat = bridge.flat_params_of(transformer.init_numpy(cfg, SEED))
    registry_dir = ROOT / "build" / "smoke_registry"
    shutil.rmtree(registry_dir, ignore_errors=True)
    step = 4242
    version = ModelRegistry(str(registry_dir)).publish(
        "transformer_lm", flat, step=step, source=f"chip_smoke seed={SEED}"
    )
    log(
        f"  weights: {flat.size} params ({flat.nbytes / 1e9:.3f} GB f32), "
        f"published as transformer_lm/v{version} in {time.perf_counter() - t0:.1f} s"
    )

    ready = threading.Event()
    holder: dict = {}
    failure: list = []

    def host():
        try:
            host_serve_task(
                param_shapes=transformer.param_shapes(cfg),
                predict_fn=lambda p, b: transformer.apply(cfg, p, b["x"]),
                port=0, device="cuda", max_batch=2,
                registry_dir=str(registry_dir), model_name="transformer_lm",
                model_version=version,
                on_ready=lambda s: (holder.update(server=s), ready.set()),
            )
        except BaseException as e:  # noqa: BLE001 — the main thread reports it
            failure.append(e)
            ready.set()

    server_thread = threading.Thread(target=host, name="serve-task", daemon=True)
    server_thread.start()
    try:
        if not ready.wait(600) or failure:
            raise SystemExit(f"replica did not come up: {failure!r}")
        launches = _ask_and_check(cfg, card, holder["server"], flat, step, version)
    finally:
        if "server" in holder:
            holder["server"].shutdown_requested.set()
        server_thread.join(120)
        shutil.rmtree(registry_dir, ignore_errors=True)
    if server_thread.is_alive() or failure:
        raise SystemExit(f"serve task did not shut down cleanly: {failure!r}")
    return launches


def _ask_and_check(cfg, card: str, server, flat, step: int, version: int) -> dict:
    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.serve import ServeClient

    t = cfg.max_seq_len
    client = ServeClient("127.0.0.1", server.port, op_timeout_s=300.0)
    side = ServeClient("127.0.0.1", server.port, op_timeout_s=300.0)
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, cfg.vocab_size, (1, t), dtype=np.int32) for _ in range(8)]
    answers: list = [None] * len(requests)
    latencies: list = [None] * len(requests)

    def ask(i, c):
        t_req = time.perf_counter()
        answers[i] = c.predict({"x": requests[i]}) + (c.last_model_version,)
        latencies[i] = time.perf_counter() - t_req

    applies0 = server.stats()["applies"]
    ops.reset_launches()  # every count to 0 just before the main path
    t_run = time.perf_counter()
    ask(0, client)
    ask(1, client)
    pair = [threading.Thread(target=ask, args=(2, client)),
            threading.Thread(target=ask, args=(3, side))]
    for th in pair:
        th.start()
    for th in pair:
        th.join(600)
    for i in range(4, len(requests)):
        ask(i, client)
    wall = time.perf_counter() - t_run
    launches = dict(ops.LAUNCHES)  # read just after the main path
    stats = client.stats()
    applies = stats["applies"] - applies0
    client.close()
    side.close()

    for i, got in enumerate(answers):
        if got is None:
            raise SystemExit(f"request {i} got no answer")
        a_step, out, a_version = got
        logits = out["output"]
        if tuple(logits.shape) != (1, t, cfg.vocab_size):
            raise SystemExit(f"request {i}: logits shape {tuple(logits.shape)}")
        if a_step != step or a_version != version:
            raise SystemExit(f"request {i}: stamps step={a_step} v={a_version}")
        if not torch.isfinite(logits.float()).all():
            raise SystemExit(f"request {i}: non-finite logits")
    log(f"  {len(requests)} answers: finite, [1, {t}, {cfg.vocab_size}], "
        f"model_step {step}, version {version}")

    # One answer against an attention="xla" apply of the same weights.
    _total, unflatten = bridge.flat_param_spec(transformer.param_shapes(cfg))
    params = unflatten(flat, "cuda")
    xla_cfg = dataclasses.replace(cfg, attention="xla")
    with torch.inference_mode():
        ref = transformer.apply(
            xla_cfg, params, torch.from_numpy(requests[0]).cuda()
        ).float().cpu()
    diff = (answers[0][1]["output"].float() - ref).abs()
    err, mean_err = diff.max().item(), diff.mean().item()
    log(
        f"  logits vs attention=xla apply: max abs {err:.4e} (tol {TOL_LOGITS:g}), "
        f"mean abs {mean_err:.4e}"
    )
    if not err <= TOL_LOGITS:
        raise SystemExit("served logits disagree with the xla-attention apply")

    # Where the time goes: one apply at the replica's padded shape on the
    # device (flash and xla attention), and its logits' copy to the host.
    padded = torch.from_numpy(np.concatenate(requests[:2])).cuda()
    with torch.inference_mode():
        apply_ms = time_ms(lambda: transformer.apply(cfg, params, padded), iters=5)
        xla_ms = time_ms(lambda: transformer.apply(xla_cfg, params, padded), iters=5)
        logits = transformer.apply(cfg, params, padded)
        torch.cuda.synchronize()
        t_copy = time.perf_counter()
        logits[:1].cpu()  # what the replica copies for a lone request
        d2h_ms = (time.perf_counter() - t_copy) * 1e3
    del params, logits
    log(
        f"  one padded apply [2, {t}] on the device: {apply_ms:.2f} ms with the "
        f"flash kernel, {xla_ms:.2f} ms with xla attention; one logits row "
        f"[1, {t}, {cfg.vocab_size}] bf16 to the host: {d2h_ms:.1f} ms [{card}]"
    )

    want = cfg.n_layers * applies
    log(
        f"  {len(requests)} predicts in {applies} applies; flash_fwd launches "
        f"{launches.get('flash_fwd', 0)} (want {cfg.n_layers} x {applies} = {want})"
    )
    if launches.get("flash_fwd", 0) != want:
        raise SystemExit("the serving path did not run the flash kernel once per layer")

    lat = np.asarray(latencies)
    p50_ms = float(np.percentile(lat, 50) * 1e3)
    tokens_per_s = len(requests) * t / wall
    log(
        f"  e2e: p50 predict latency {p50_ms:.1f} ms (client round trip, "
        f"[1, {t}] -> [1, {t}, {cfg.vocab_size}] bf16), "
        f"{tokens_per_s:.0f} tokens/s over {len(requests)} requests "
        f"in {wall:.2f} s; server-side p50 "
        f"{stats.get('serve/latency_p50_ms', float('nan')):.1f} ms [{card}]"
    )
    return launches


def train_end_to_end(card: str, kernel_ms: dict) -> dict:
    """Train, check, compare and publish (the module docstring's phase 4);
    returns the kernel launch counts of the main path's run."""
    from distributed_tensorflow_examples_tpu_torch import bridge, ops
    from distributed_tensorflow_examples_tpu_torch.data import datasets
    from distributed_tensorflow_examples_tpu_torch.examples import transformer_lm as cli
    from distributed_tensorflow_examples_tpu_torch.models import transformer
    from distributed_tensorflow_examples_tpu_torch.serve import ModelRegistry
    from distributed_tensorflow_examples_tpu_torch.train import hooks, optim, state, step

    class StepClock(hooks.Hook):
        """Wall time and loss of every step; reading the loss waits for
        the step's device work."""

        def __init__(self):
            self.steps: list = []

        def begin(self, loop):
            torch.cuda.synchronize()
            self._t = time.perf_counter()

        def after_step(self, loop, metrics):
            loss = float(metrics["loss"])
            now = time.perf_counter()
            self.steps.append((loop.step, (now - self._t) * 1e3, loss))
            self._t = now

    registry_dir = ROOT / "build" / "smoke_train_registry"
    shutil.rmtree(registry_dir, ignore_errors=True)
    t_len = 2048
    args = cli.build_parser().parse_args([
        f"--batch_size={TRAIN_BATCH}", f"--seq_len={t_len}", "--vocab_size=32000",
        "--dim=1024", "--n_layers=12", "--n_heads=8", f"--train_steps={TRAIN_STEPS}",
        "--learning_rate=1e-3", "--log_every_steps=1", f"--seed={SEED}",
        "--attention=auto", f"--registry_dir={registry_dir}", "--device=cuda",
    ])
    cfg = cli.config_from_args(args)
    clock = StepClock()
    ops.reset_launches()  # every count to 0 just before the main path
    t0 = time.perf_counter()
    exp = cli.run_training(args, extra_hooks=[clock])
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)  # read just after the main path
    try:
        losses = [loss for _s, _ms, loss in clock.steps]
        log("  steps: " + ", ".join(
            f"{s}: loss {loss:.4f} in {ms:.1f} ms" for s, ms, loss in clock.steps
        ))
        want = cfg.n_layers * TRAIN_STEPS
        log(
            f"  {TRAIN_STEPS} steps of [{TRAIN_BATCH}, {t_len}] in {wall:.1f} s "
            f"(corpus, init, steps, publish); launches "
            + ", ".join(f"{k} {launches.get(k, 0)}" for k in ("flash_fwd", "flash_dq", "flash_dkv"))
            + f" (want {cfg.n_layers} x {TRAIN_STEPS} = {want} each)"
        )
        if len(losses) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"training losses not finite: {losses}")
        if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5 or not losses[-1] < losses[0]:
            raise SystemExit(
                f"training loss did not start near ln({cfg.vocab_size}) = "
                f"{math.log(cfg.vocab_size):.3f} and fall: {losses}"
            )
        for k in ("flash_fwd", "flash_dq", "flash_dkv"):
            if launches.get(k, 0) != want:
                raise SystemExit(f"the training path did not run {k} once per layer and step")

        reg = ModelRegistry(str(registry_dir))
        got_step, flat, _manifest = reg.load("transformer_lm", exp.published_version)
        trained = bridge.flat_params_of(exp.state.params)
        if got_step != TRAIN_STEPS or not np.array_equal(flat, trained):
            raise SystemExit("the published version does not hold the trained parameters")
        log(f"  published transformer_lm/v{exp.published_version} at step {got_step}: "
            f"{flat.size} params round-trip bit for bit")

        step_ms = float(np.median([ms for _s, ms, _l in clock.steps[1:]]))
        tokens_per_s = TRAIN_BATCH * t_len / (step_ms / 1e3)
        per_layer = {k: kernel_ms[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")}
        kernel_step_ms = cfg.n_layers * sum(per_layer.values())
        log(
            f"  e2e: step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}, host clock "
            f"to the loss read), {tokens_per_s:.0f} tokens/s; the flash kernels' "
            f"share of a step {kernel_step_ms / step_ms:.1%} ({cfg.n_layers} x ("
            + " + ".join(f"{k} {v:.3f}" for k, v in per_layer.items())
            + f") = {kernel_step_ms:.1f} ms at [{TRAIN_BATCH * cfg.n_heads}, {t_len}, "
            f"{cfg.head_dim}], CUDA events) [{card}]"
        )
    finally:
        shutil.rmtree(registry_dir, ignore_errors=True)
    del exp

    # One step's loss and gradients from the initial weights on the first
    # batch: the flash kernels against plain mha (attention="xla").
    ids, _vocab, _src = datasets.text_corpus(
        None, vocab_size=cfg.vocab_size,
        synth_tokens=max(2_000_000, TRAIN_BATCH * (t_len + 1) * 50), seed=SEED,
    )
    first = next(datasets.lm_batches(ids, batch_size=TRAIN_BATCH, seq_len=t_len))
    batch = {k: torch.from_numpy(v).cuda() for k, v in first.items()}
    init = transformer.init_numpy(cfg, SEED)
    paths = [p for p, _l in bridge._leaves(init)]
    result = {}
    for attention in ("auto", "xla"):
        c = dataclasses.replace(cfg, attention=attention)
        params = state.as_param_leaves(init, "cuda")
        loss, _ = transformer.loss_fn(c)(params, {}, batch, None)
        loss.backward()
        result[attention] = (loss.item(), [p.grad for p in state.leaves(params)])
        del params, loss
    (l_flash, g_flash), (l_xla, g_xla) = result["auto"], result["xla"]
    rels = [((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()
            for a, b in zip(g_flash, g_xla)]
    worst = int(np.argmax(rels))
    log(
        f"  step 1 vs attention=xla (same weights, batch [{TRAIN_BATCH}, {t_len}]): "
        f"loss {l_flash:.5f} vs {l_xla:.5f} (|Δ| {abs(l_flash - l_xla):.2e}, tol "
        f"{TOL_TRAIN_LOSS:g}; the training run's step 1 read {losses[0]:.5f}); "
        f"per-leaf gradient error max {rels[worst]:.3e} at {paths[worst]}, median "
        f"{float(np.median(rels)):.3e} (tol {TOL_TRAIN_GRAD:g})"
    )
    if not (abs(l_flash - l_xla) <= TOL_TRAIN_LOSS and rels[worst] <= TOL_TRAIN_GRAD):
        raise SystemExit("the flash training step disagrees with the xla-attention step")
    del result, g_flash, g_xla

    # Where a step's time goes: one full step (after a warm-up step) under
    # torch.profiler, device time summed by kernel family, against the host
    # clock around the step.
    from torch.profiler import ProfilerActivity, profile

    opt = optim.ClippedAdamW(1e-3, 1.0)
    st = state.create_state(lambda seed: init, opt, SEED, "cuda")
    train_step = step.build_train_step(transformer.loss_fn(cfg), opt)
    st, m = train_step(st, batch)
    float(m["loss"])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st, m = train_step(st, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Only device-side rows: a CPU op's row repeats its kernels' device time,
    # and CUPTI's own markers are not work.
    from torch.autograd import DeviceType

    families: dict = {}
    kernels = []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if us <= 0 or e.device_type != DeviceType.CUDA or e.key in CUPTI_MARKERS:
            continue
        kernels.append((us, e.count, e.key))
        name = e.key.lower()
        fam = next((f for f in ("flash_fwd", "flash_dq", "flash_dkv") if f + "_kernel" in name), None)
        if fam is None:
            fam = next((f for f, keys in KERNEL_FAMILIES if any(k in name for k in keys)), "other")
        families[fam] = families.get(fam, 0.0) + us / 1e3
    busy_ms = sum(families.values())
    if busy_ms <= 0:
        raise SystemExit("torch.profiler recorded no device time for the profiled step")
    log(
        f"  profiled step: host {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle share {max(0.0, 1 - busy_ms / wall_ms):.1%}); by family: "
        + ", ".join(f"{k} {v:.1f} ms ({v / busy_ms:.1%})"
                    for k, v in sorted(families.items(), key=lambda kv: -kv[1]))
    )
    for us, count, key in sorted(kernels, reverse=True)[:10]:
        log(f"    {us / 1e3:8.2f} ms in {count:4d} launches  {key[:110]}")
    log(f"  [{card}]")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from distributed_tensorflow_examples_tpu_torch.ops import _build
    from distributed_tensorflow_examples_tpu_torch.ops import flash_attention as flash

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    log("phase 1: build")
    sources = ["flash_fwd", "flash_bwd"]
    t0 = time.perf_counter()
    built = _build.build(sources)
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in built.items()})})")
    for name in sources:
        ptxas = Path(str(_build.library_path(name)) + ".log")
        if ptxas.exists():
            for line in ptxas_report(ptxas.read_text()):
                log(f"  ptxas: {line}")

    log("phase 2: kernels against their plain versions on the card")
    # The serving path's shape: the replica pads every apply to max_batch = 2
    # rows, so each layer's call folds 2 x 8 heads into BH = 16.
    errs = [
        check_flash(flash, 16, 2048, 128, torch.bfloat16, True),
        check_flash(flash, 8, 2048, 128, torch.bfloat16, False),
        check_flash(flash, 8, 1000, 128, torch.bfloat16, True),
        check_flash(flash, 8, 2048, 64, torch.bfloat16, True),
        check_flash(flash, 8, 2048, 32, torch.bfloat16, True),
        check_flash(flash, 8, 1000, 64, torch.float32, True, out_dtype=torch.float32),
        check_flash(flash, 8, 2048, 128, torch.bfloat16, True, out_dtype=torch.float32),
    ]
    # The training path's shape: batch 8 x 8 heads = BH 64.
    train_bh = TRAIN_BATCH * 8
    bwd_errs = [
        check_flash_bwd(flash, train_bh, 2048, 128, torch.bfloat16, True, determinism=True),
        check_flash_bwd(flash, 8, 2048, 128, torch.bfloat16, False),
        check_flash_bwd(flash, 8, 1000, 128, torch.bfloat16, True),
        check_flash_bwd(flash, 8, 1000, 64, torch.bfloat16, True),
        check_flash_bwd(flash, 8, 2048, 32, torch.bfloat16, True),
        check_flash_bwd(flash, 8, 1000, 64, torch.float32, True, out_dtype=torch.float32),
        check_flash_bwd(flash, 8, 1000, 32, torch.float32, False, out_dtype=torch.float32),
    ]
    main_shape = time_flash(flash, 16, 2048, 128, torch.bfloat16, True)
    train_fwd = time_flash(flash, train_bh, 2048, 128, torch.bfloat16, True)
    time_flash(flash, 8, 2048, 128, torch.bfloat16, False)
    bwd = time_flash_bwd(flash, train_bh, 2048, 128, torch.bfloat16, True)
    log(f"  [{card}]")

    log("phase 3: serve the flagship transformer end to end")
    serve_launches = serve_end_to_end(card)

    log("phase 4: train the flagship transformer end to end")
    kernel_ms = {"flash_fwd": train_fwd["ms"], **{k: v["ms"] for k, v in bwd.items()}}
    train_launches = train_end_to_end(card, kernel_ms)

    csrc = "distributed_tensorflow_examples_tpu_torch/ops/csrc"
    tpu = "distributed_tensorflow_examples_tpu/ops/flash_attention.py"
    record = {"kernels": [
        {
            "name": "flash_fwd", "route": "cuda", "source": f"{csrc}/flash_fwd.cu",
            "replaces": f"{tpu}:135",
            "launches": serve_launches.get("flash_fwd", 0)
            + train_launches.get("flash_fwd", 0),
            "launches_by_path": {"serve": serve_launches.get("flash_fwd", 0),
                                 "train": train_launches.get("flash_fwd", 0)},
            "max_abs_err": max(errs), **main_shape,
        },
        *({
            "name": name, "route": "cuda", "source": f"{csrc}/flash_bwd.cu",
            "replaces": f"{tpu}:{line}",
            "launches": train_launches.get(name, 0),
            "launches_by_path": {"train": train_launches.get(name, 0)},
            "max_abs_err": max(e[name] for e in bwd_errs), **bwd[name],
        } for name, line in (("flash_dq", 211), ("flash_dkv", 244))),
    ]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
