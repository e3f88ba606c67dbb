"""Where a training step's time goes: the port's twin of
``tools/profile_step.py``, and the trace reader that ``train/hooks.py``'s
``ProfilerHook`` and ``chip_smoke.py`` read their windows with::

    python -m distributed_tensorflow_examples_tpu_torch.tools.profile_step \\
        --model transformer|moe|resnet50|lstm|word2vec|mlp \\
        [--batch-per-chip N] [--steps 5] [--warmup 3] [--top 30] \\
        [--device=cpu] [-- <model flags>]

The entry point runs the port's CLI for the model at ``bench.py``'s
shapes with ``--profile`` and a ``--log_dir`` (the ``ProfilerHook``'s
window is narrowed to ``--steps`` steps after ``--warmup``), reads the
Chrome trace the hook wrote, and prints the device time by kernel family
and by kernel, the launches, the busy time and the idle share, the host
ops with most self time and the longest device-idle gaps with the host
op open across each; then one JSON line.  Flags after ``--`` go to the
CLI as they are (``--device=cpu`` and small widths let a test run it on
the CPU, where the window holds host ops only).  On the card every
printout names the card and its power limit.

The reader is plain functions over a :class:`Trace`, which :func:`load`
makes from a finished ``torch.profiler.profile`` or from a saved Chrome
trace (``.json`` or ``.json.gz``).  The profiler's own marker rows
(``CUPTI_MARKERS``) are dropped.  Device busy time is the union of the
device's intervals; a family or a kernel sums its rows' durations.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import glob
import gzip
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict
from unittest import mock

#: Device rows of a profile that are the profiler's own markers, not work.
CUPTI_MARKERS = ("Command Buffer Full", "Activity Buffer Request")
#: The port's flash kernels, by kernel name.
FLASH_FAMILIES = ("flash_fwd", "flash_dq", "flash_dkv", "flash_fused_bwd", "fused_dq_reduce")
#: Kernel families of an LM step, by substrings of the lower-cased kernel
#: name, the first that matches; ``other`` for the rest.
LM_FAMILIES = (
    *((f, (f + "_kernel", f + "_tc_kernel")) for f in FLASH_FAMILIES),
    ("nccl", ("nccl",)),
    ("optimizer", ("adam", "multi_tensor_apply")),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("reduce", ("reduce", "norm", "softmax", "logsumexp")),
    ("copy/cast", ("copy", "memcpy", "memset", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
#: Kernel families of a ResNet-50 step.
RESNET_FAMILIES = (
    ("bn_stats", ("bn_stats_partial",)),
    ("bn_bwd_stats", ("bn_bwd_stats_partial",)),
    ("bn finalize (both)", ("bn_stats_finalize",)),
    ("nccl", ("nccl",)),
    ("optimizer", ("sgd", "multi_tensor_apply")),
    ("layout transform", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("conv/cuDNN", ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad", "fprop",
                    "sm90", "gemm", "cutlass", "nvjet")),
    ("pool", ("pool",)),
    ("reduce", ("reduce", "softmax", "logsumexp")),
    ("copy/cast", ("copy", "memcpy", "memset", "fill", "pad")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
#: Chrome-trace categories of device rows and of host rows.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_NOT_EVENTS = ("[memory]", "[OutOfMemory]")


@dataclasses.dataclass
class Trace:
    """A profiled window: ``device`` rows (name, start us, end us),
    ``host`` rows (name, start us, end us, self us) and the device us of
    the work each host op launched itself (``op_device_us``)."""

    device: list
    host: list
    op_device_us: dict


def load(source) -> Trace:
    """A :class:`Trace` from a ``torch.profiler.profile`` that has ended,
    a saved Chrome trace's path, or a ``Trace``."""
    if isinstance(source, Trace):
        return source
    if isinstance(source, (str, os.PathLike)):
        opener = gzip.open if str(source).endswith(".gz") else open
        with opener(source, "rt") as f:
            return _from_chrome(json.load(f))
    return _from_profile(source)


def _from_profile(prof) -> Trace:
    from torch.autograd import DeviceType

    device, host, by_op = [], [], defaultdict(float)
    for e in prof.events():
        if e.name in CUPTI_MARKERS or e.name in _NOT_EVENTS:
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            host.append((e.name, start, end, e.self_cpu_time_total))
            if e.self_device_time_total > 0:
                by_op[e.name] += e.self_device_time_total
        else:
            device.append((e.name, start, end))
    return Trace(device, host, dict(by_op))


def _from_chrome(obj) -> Trace:
    events = obj["traceEvents"] if isinstance(obj, dict) else obj
    device, spans, ext_op = [], defaultdict(list), {}
    launched = []
    for e in events:
        if e.get("ph") != "X" or e.get("name") in CUPTI_MARKERS:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        ext = e.get("args", {}).get("External id")
        if cat in _DEVICE_CATS:
            device.append((e["name"], start, end))
            if ext is not None:
                launched.append((ext, end - start))
        elif cat in _HOST_CATS:
            spans[(e.get("pid"), e.get("tid"))].append((e["name"], start, end))
            if cat == "cpu_op" and ext is not None:
                ext_op[ext] = e["name"]
    host = []
    for rows in spans.values():
        host.extend(_with_self_time(rows))
    by_op: dict = defaultdict(float)
    for ext, us in launched:
        if ext in ext_op:
            by_op[ext_op[ext]] += us
    return Trace(device, host, dict(by_op))


def _with_self_time(rows: list) -> list:
    """One thread's (name, start, end) rows with their self time: the
    duration less that of the rows directly inside."""
    rows = sorted(rows, key=lambda r: (r[1], -r[2]))
    out, stack = [], []
    for name, start, end in rows:
        while stack and stack[-1][2] <= start:
            stack.pop()
        row = [name, start, end, end - start]
        if stack:
            stack[-1][3] -= min(end, stack[-1][2]) - start
        stack.append(row)
        out.append(row)
    return [tuple(r) for r in out]


def _is_copy(name: str) -> bool:
    return name.lower().startswith(("memcpy", "memset"))


def device_ms_by_kernel(trace: Trace) -> dict:
    """Device ms by row name (kernels, copies and sets)."""
    out: dict = defaultdict(float)
    for name, start, end in trace.device:
        out[name] += (end - start) / 1e3
    return dict(out)


def launches_by_kernel(trace: Trace) -> dict:
    """Rows by name: a kernel's launches, a copy's or a set's count."""
    out: dict = defaultdict(int)
    for name, _s, _e in trace.device:
        out[name] += 1
    return dict(out)


def by_family(trace: Trace, families=LM_FAMILIES) -> dict:
    """{family: {"ms": device ms, "launches": rows}}: a row's family is the
    first of ``families`` with a substring of its lower-cased name."""
    out: dict = {}
    for name, start, end in trace.device:
        low = name.lower()
        family = next((f for f, keys in families if any(k in low for k in keys)), "other")
        row = out.setdefault(family, {"ms": 0.0, "launches": 0})
        row["ms"] += (end - start) / 1e3
        row["launches"] += 1
    return out


def _busy_intervals(trace: Trace) -> list:
    merged: list = []
    for _n, start, end in sorted(trace.device, key=lambda r: r[1]):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def busy_ms(trace: Trace) -> float:
    """The union of the device's intervals, in ms."""
    return sum(end - start for start, end in _busy_intervals(trace)) / 1e3


def window_ms(trace: Trace) -> float:
    """From the first row's start to the last row's end, in ms."""
    rows = [(s, e) for _n, s, e in trace.device] + [(s, e) for _n, s, e, _x in trace.host]
    return (max(e for _s, e in rows) - min(s for s, _e in rows)) / 1e3 if rows else 0.0


def host_ops(trace: Trace, top: int = 6) -> list:
    """[(name, self ms, count)] of the host ops with most self time."""
    agg: dict = defaultdict(lambda: [0.0, 0])
    for name, _s, _e, self_us in trace.host:
        agg[name][0] += self_us / 1e3
        agg[name][1] += 1
    return sorted(((k, v[0], v[1]) for k, v in agg.items()), key=lambda r: -r[1])[:top]


def idle_gaps(trace: Trace, top: int = 5) -> list:
    """The ``top`` longest spans of the window with no device row (the
    first row's start to the first device row, between device rows, the
    last device row to the last row's end): [(ms, start ms into the
    window, the innermost host op open across the whole span, else the
    one open at its middle, else "")]; none in a window without device
    rows."""
    if not trace.device:
        return []
    rows = [(s, e) for _n, s, e in trace.device] + [(s, e) for _n, s, e, _x in trace.host]
    t0, t1 = min(s for s, _e in rows), max(e for _s, e in rows)
    edges = [t0] + [x for iv in _busy_intervals(trace) for x in iv] + [t1]
    gaps = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a),
                  reverse=True)[:top]
    out = []
    for length, a, b in gaps:
        across = [h for h in trace.host if h[1] <= a and h[2] >= b]
        mid = (a + b) / 2
        open_ = across or [h for h in trace.host if h[1] <= mid <= h[2]]
        op = min(open_, key=lambda h: h[2] - h[1])[0] if open_ else ""
        out.append((length / 1e3, (a - t0) / 1e3, op))
    return out


def device_ms_by_op(trace: Trace) -> dict:
    """Device ms of the work each host op launched itself, by op name."""
    return {k: v / 1e3 for k, v in trace.op_device_us.items()}


def summary(trace, *, wall_ms: float | None = None, families=None, top: int = 10) -> dict:
    """The window in one JSON-able dict: busy ms, the window's ms
    (``wall_ms``, else the rows' span) and the idle share, kernel launches
    and copies/sets, the ``top`` kernels by device ms with their launches,
    every row's launches, the host ops with most self time, the longest
    idle gaps, and (``families`` a table) the device ms and launches by
    family."""
    trace = load(trace)
    busy = busy_ms(trace)
    window = wall_ms if wall_ms is not None else window_ms(trace)
    launches = launches_by_kernel(trace)
    ms = device_ms_by_kernel(trace)
    out = {
        "busy_ms": busy, "window_ms": window,
        "idle_share": max(0.0, 1 - busy / window) if window > 0 else 0.0,
        "kernels": sum(n for k, n in launches.items() if not _is_copy(k)),
        "copies": sum(n for k, n in launches.items() if _is_copy(k)),
        "top_kernels": [[k, ms[k], launches[k]]
                        for k in sorted(ms, key=lambda k: -ms[k])[:top]],
        "launches": launches,
        "host_ops": [list(r) for r in host_ops(trace, top)],
        "gaps": [list(g) for g in idle_gaps(trace, 5)],
    }
    if families is not None:
        out["families"] = by_family(trace, families)
    return out


def tables(s: dict, steps: int = 1) -> list[str]:
    """Printable lines of a :func:`summary`, per step over ``steps``."""
    lines = [f"device busy {s['busy_ms'] / steps:.3f} ms a step of {s['window_ms'] / steps:.3f} "
             f"(idle share {s['idle_share']:.1%}); {s['kernels'] / steps:.1f} kernel launches "
             f"and {s['copies'] / steps:.1f} copies/sets a step"]
    fams = s.get("families")
    if fams:
        total = sum(v["ms"] for v in fams.values()) or 1.0
        lines.append("by family (ms a step): " + ", ".join(
            f"{k} {v['ms'] / steps:.3f} ({v['ms'] / total:.1%}, {v['launches'] / steps:g} "
            f"launches)" for k, v in sorted(fams.items(), key=lambda kv: -kv[1]["ms"])))
    for name, ms, n in s["top_kernels"]:
        lines.append(f"  {ms / steps:9.3f} ms {n / steps:7.1f} launches  {name[:110]}")
    lines.append("host, most self time (ms a step): " + ", ".join(
        f"{k} {ms / steps:.3f} ({n})" for k, ms, n in s["host_ops"]))
    lines.append("longest device-idle gaps: " + (", ".join(
        f"{ms:.3f} ms at {at:.3f} ms under {op or '-'}" for ms, at, op in s["gaps"]) or "none"))
    return lines


# ----------------------------------------------------------------------------
# The entry point
# ----------------------------------------------------------------------------

#: ``bench.py``'s shapes for each model: (CLI module, flags, batch per chip).
MODELS = {
    "transformer": ("transformer_lm", ["--vocab_size=32000", "--dim=1024", "--n_layers=12",
                                       "--n_heads=8", "--seq_len=2048",
                                       "--learning_rate=1e-3"], 8),
    "moe": ("transformer_lm", ["--vocab_size=32000", "--dim=1024", "--n_layers=12",
                               "--n_heads=8", "--seq_len=2048", "--learning_rate=1e-3",
                               "--moe_experts=8"], 4),
    "resnet50": ("resnet50", ["--image_size=224", "--num_classes=1000",
                              "--learning_rate=0.1", "--momentum=0.9"], 256),
    "lstm": ("ptb_lstm", ["--vocab_size=10000", "--hidden_dim=200", "--num_layers=2",
                          "--seq_len=20", "--learning_rate=1.0"], 256),
    "word2vec": ("word2vec", ["--vocab_size=100000", "--embedding_dim=256",
                              "--learning_rate=0.5"], 4096),
    "mlp": ("mnist_mlp", ["--learning_rate=0.05"], 1024),
}


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def profile_cli(model: str, *, steps: int, warmup: int, batch_per_chip: int | None,
                log_dir: str, cli_flags: list) -> str:
    """Run the model's CLI with ``--profile`` for ``warmup + steps`` steps,
    the window the last ``steps``; returns the path of rank 0's trace."""
    import importlib

    from ..train import hooks

    module, flags, batch = MODELS[model]
    cli = importlib.import_module(f"distributed_tensorflow_examples_tpu_torch.examples.{module}")
    argv = [*flags, f"--batch_size={batch_per_chip or batch}",
            f"--train_steps={warmup + steps}", "--profile", f"--log_dir={log_dir}",
            f"--log_every_steps={warmup + steps}", *cli_flags]
    window = functools.partial(hooks.ProfilerHook, start_step=warmup, num_steps=steps)
    with mock.patch.object(hooks, "ProfilerHook", window), \
            contextlib.redirect_stdout(sys.stderr):
        cli.run_training(cli.build_parser().parse_args(argv))
    traces = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile", "*",
                                           "rank0.pt.trace.json")))
    if not traces:
        raise FileNotFoundError(f"no trace under {log_dir}/plugins/profile")
    return traces[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="transformer", choices=sorted(MODELS))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--batch-per-chip", type=int, default=None)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--log-dir", default="",
                    help="where the CLI writes (default: a new temporary directory)")
    args, cli_flags = ap.parse_known_args(argv)
    cli_flags = [f for f in cli_flags if f != "--"]
    import torch

    on_card = "--device=cpu" not in cli_flags
    if on_card and not torch.cuda.is_available():
        print("profile_step: no CUDA device (pass --device=cpu for a host-only window)",
              file=sys.stderr)
        return 2
    card = card_line() if on_card else "cpu"
    log_dir = args.log_dir or tempfile.mkdtemp(prefix="dtx_profile_")
    path = profile_cli(args.model, steps=args.steps, warmup=args.warmup,
                       batch_per_chip=args.batch_per_chip, log_dir=log_dir,
                       cli_flags=cli_flags)
    families = RESNET_FAMILIES if args.model == "resnet50" else LM_FAMILIES
    trace = load(path)
    with open(path.replace(".pt.trace.json", ".summary.json")) as f:
        wall_ms = json.load(f)["window_ms"]
    s = summary(trace, wall_ms=wall_ms, families=families, top=args.top)
    print(f"{args.model}: {args.steps} profiled steps after {args.warmup} [{card}]")
    for line in tables(s, args.steps):
        print(line)
    print(f"trace: {path}")
    print(json.dumps({"model": args.model, "card": card, "steps": args.steps,
                      "busy_ms_per_step": s["busy_ms"] / args.steps,
                      "step_ms": s["window_ms"] / args.steps, "idle_share": s["idle_share"],
                      "families_ms_per_step": {k: v["ms"] / args.steps
                                               for k, v in s["families"].items()},
                      "kernels_per_step": s["kernels"] / args.steps, "trace": path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
